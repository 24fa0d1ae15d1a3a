"""Elementary-op inverse trig vs numpy references."""
import numpy as np
import jax
import jax.numpy as jnp

from fourd_ray_tracing_tpu.ops import fastmath


def test_arctan_accuracy():
    x = np.linspace(-50, 50, 100001).astype(np.float32)
    got = np.asarray(fastmath.arctan(jnp.asarray(x)))
    want = np.arctan(x.astype(np.float64))
    assert np.abs(got - want).max() < 5e-7


def test_arctan2_quadrants():
    ys = np.array([0.0, 1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 0.0], np.float32)
    xs = np.array([1.0, 1.0, 1.0, -1.0, -1.0, 0.0, 0.0, -1.0], np.float32)
    got = np.asarray(fastmath.arctan2(jnp.asarray(ys), jnp.asarray(xs)))
    want = np.arctan2(ys, xs)
    np.testing.assert_allclose(got, want, atol=5e-7)


def test_arccos_accuracy_and_edges():
    x = np.linspace(-1, 1, 100001).astype(np.float32)
    got = np.asarray(fastmath.arccos(jnp.asarray(x)))
    want = np.arccos(np.clip(x.astype(np.float64), -1, 1))
    assert np.abs(got - want).max() < 1e-6
    # exact endpoints
    assert abs(float(fastmath.arccos(jnp.float32(1.0)))) < 1e-6
    assert abs(float(fastmath.arccos(jnp.float32(-1.0))) - np.pi) < 1e-6
    # clamping out-of-range
    assert np.isfinite(float(fastmath.arccos(jnp.float32(1.5))))


def test_arcsin_accuracy():
    x = np.linspace(-1, 1, 10001).astype(np.float32)
    got = np.asarray(fastmath.arcsin(jnp.asarray(x)))
    want = np.arcsin(x.astype(np.float64))
    assert np.abs(got - want).max() < 1e-6


def test_gradients_finite_in_interior():
    g = jax.grad(lambda x: fastmath.arccos(x))(jnp.float32(0.3))
    want = -1.0 / np.sqrt(1 - 0.3**2)
    np.testing.assert_allclose(float(g), want, rtol=1e-4)


def test_sincos_2pi_accuracy():
    """The production azimuth pair vs float64 sin/cos over [0, 1) turns,
    plus quadrant boundaries exactly at multiples of 1/4."""
    u = np.linspace(0.0, 1.0, 100001, endpoint=False).astype(np.float32)
    u = np.concatenate([u, np.array([0.0, 0.25, 0.5, 0.75], np.float32)])
    sin, cos = fastmath.sincos_2pi(jnp.asarray(u))
    want_s = np.sin(2 * np.pi * u.astype(np.float64))
    want_c = np.cos(2 * np.pi * u.astype(np.float64))
    assert np.abs(np.asarray(sin) - want_s).max() < 3e-7
    assert np.abs(np.asarray(cos) - want_c).max() < 3e-7
    # unit circle: rho^2 stays normalized for the hat-box assembly
    norm = np.asarray(sin) ** 2 + np.asarray(cos) ** 2
    assert np.abs(norm - 1.0).max() < 1e-6
