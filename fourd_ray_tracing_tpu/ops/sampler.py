"""Uniform direction sampling on the unit 3-sphere S^3 in R^4.

The reference's "novel piece" (README.md:9-13): sample the 4th
coordinate w from the marginal of the uniform distribution on S^3
(density (2/pi)*sqrt(1-w^2)) by numerically inverting its CDF

    volume_by_w(w) = (w*sqrt(1-w^2) - acos(w))/pi + 1     (shader.frag:136-138)

then place the remaining 3D part uniformly on the 2-sphere of radius
sqrt(1-w^2) via the Archimedes hat-box trick (shader.frag:153-158).

Two inverse-CDF implementations:

* `w_by_volume_newton` — a faithful re-expression of the reference's
  finite-difference Newton do-while loop (shader.frag:141-150), with
  per-lane masked iteration so the vectorized result equals the scalar
  reference lane-for-lane. This is the oracle/test mode. Its
  data-dependent trip count is hostile to vector lanes (SURVEY §7 "hard
  parts") — every lane pays for the slowest lane.

* `w_by_volume_kepler` — a fixed-cost production mode. Substituting
  w = cos(x/2) turns the CDF equation into Kepler's equation

      x - sin(x) = 2*pi*(1 - v),   x in [0, 2*pi]

  solved in a *fixed* number of ops: cube-root initial guess + Halley
  iterations (cubic convergence). Same monotone map v -> w as the
  reference, so with the same RNG stream it yields the same directions
  to ~1e-6 — tighter than the reference's own 2^-12 Newton tolerance —
  at a fraction of the transcendental cost and with static control flow.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from fourd_ray_tracing_tpu.ops.vec4 import Vec4

PI = np.float32(3.14159265)
TWO_PI = np.float32(2.0) * PI
# "Small value, about 2^-12" (shader.frag:24).
SMALL_FLOAT = np.float32(0.0003)


def volume_by_w(w: jnp.ndarray) -> jnp.ndarray:
    """CDF of the w-marginal of the uniform S^3 distribution (shader.frag:136-138)."""
    w = jnp.asarray(w, jnp.float32)
    return (w * jnp.sqrt(1.0 - w * w) - jnp.arccos(w)) / PI + 1.0


def w_by_volume_newton(v: jnp.ndarray, max_iters: int = 64) -> jnp.ndarray:
    """Invert volume_by_w exactly as the reference does (shader.frag:141-150).

    Finite-difference Newton from w=0 with one-sided step SMALL_FLOAT,
    iterated per-lane until that lane's |dw| < SMALL_FLOAT (do-while
    semantics: every lane runs at least one iteration). ``max_iters``
    bounds pathological non-convergence (the GLSL loop is unbounded).
    """
    v = jnp.asarray(v, jnp.float32)
    w0 = jnp.zeros_like(v)
    active0 = jnp.ones_like(v, dtype=bool)

    def body(state):
        w, active, it = state
        old_v = volume_by_w(w)
        df = jnp.where(
            w > 0.0,
            old_v - volume_by_w(w - SMALL_FLOAT),
            volume_by_w(w + SMALL_FLOAT) - old_v,
        )
        new_w = w - SMALL_FLOAT / df * (old_v - v)
        keep_going = jnp.abs(new_w - w) >= SMALL_FLOAT
        w = jnp.where(active, new_w, w)
        active = jnp.logical_and(active, keep_going)
        return w, active, it + 1

    def cond(state):
        _, active, it = state
        # max over an int mask: Triton lowers reduce_max, not reduce_or.
        any_active = jnp.max(jnp.where(active, 1, 0)) > 0
        return jnp.logical_and(any_active, it < max_iters)

    w, _, _ = jax.lax.while_loop(cond, body, (w0, active0, jnp.int32(0)))
    return w


def _cbrt_nonneg(x: jnp.ndarray) -> jnp.ndarray:
    """cbrt for x >= 0 via exp(log/3) (no cbrt primitive needed);
    double-where keeps the x=0 lane and its gradient finite."""
    pos = x > 0.0
    safe = jnp.exp(jnp.log(jnp.where(pos, x, 1.0)) * (1.0 / 3.0))
    return jnp.where(pos, safe, 0.0)


def _solve_kepler_half(c: jnp.ndarray, iters: int) -> jnp.ndarray:
    """Solve x - sin(x) = c for c in [0, pi], x in [0, pi]."""
    # Cube-root seed: x - sin x ~ x^3/6 near 0; globally decent on [0, pi].
    x = _cbrt_nonneg(6.0 * c)
    for _ in range(iters):
        s = jnp.sin(x)
        co = jnp.cos(x)
        f = x - s - c
        fp = 1.0 - co
        fpp = s
        # Halley step; fp >= 0, add tiny eps to avoid 0/0 at x=0 (f=0 there too).
        denom = 2.0 * fp * fp - f * fpp
        x = x - 2.0 * f * fp / jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)
    return x


# --- Polynomial inverse CDF (the default production mode) -----------------
#
# Through the same Kepler substitution w = cos(x/2), x - sin(x) = c,
# c = 2*pi*(1 - v), the half-range solution w(c) for c in [0, pi] is an
# EVEN analytic function of t = cbrt(6c) (x(t) is odd, cos of odd is
# even), i.e. a smooth function of u = t^2 = (6c)^(2/3). A degree-8
# Chebyshev fit of w(u) over u in [0, (6*pi)^(2/3)] reaches max error
# 3.2e-7 in float64 AND in float32 Horner evaluation (fit script:
# numpy vs a float64 Newton oracle on 4e5 nodes) — tighter than both the
# reference's 2^-12 Newton tolerance and the 2-iteration Halley solver —
# with zero sin/cos/exp/log past the cube root. This removes ~5
# transcendentals per diffuse bounce vs `w_by_volume_kepler` (measured
# +8% rays/s per Halley iteration removed, tools/ab_bench.py).
_W_POLY = tuple(
    np.float32(c)
    for c in (
        9.99999681e-01,
        -1.24997268e-01,
        -1.56926491e-03,
        -5.38844444e-05,
        -7.60478346e-06,
        1.29518987e-06,
        -3.00660743e-07,
        2.97591143e-08,
        -1.48590700e-09,
    )
)


def _div3_u32(i: jnp.ndarray) -> jnp.ndarray:
    """Approximate unsigned i/3 with shifts/adds only (no integer
    divide): i/3 = i/4 * sum_k 4^-k; 8 terms leave ~5e-6 relative
    error — irrelevant for an exponent-trick seed."""
    acc = i >> 2
    t = acc
    for _ in range(7):
        t = t >> 2
        acc = acc + t
    return acc


def _cbrt_sq_bits(a: jnp.ndarray, iters: int = 3) -> jnp.ndarray:
    """a^(2/3) for a >= 0 via an exponent bit-trick seed for a^(-1/3)
    plus division-free Newton (z' = z*(4 - a*z^3)/3), then a*z*z.

    Transcendental-free (shifts, fma, bitcast only).
    3 iterations: <4e-6 relative (magic 0x548fe000 tuned over
    a in [1e-6, 400]); the render range is a = 36*c^2 <= 36*pi^2 < 356.
    """
    a = jnp.maximum(jnp.asarray(a, jnp.float32), 1e-30)  # keep z finite
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    z = jax.lax.bitcast_convert_type(
        jnp.uint32(0x548FE000) - _div3_u32(bits), jnp.float32
    )
    third = np.float32(1.0 / 3.0)
    for _ in range(iters):
        z = z * (4.0 - a * z * z * z) * third
    return a * z * z


def w_by_volume_poly(v: jnp.ndarray, cbrt_iters: int = 3) -> jnp.ndarray:
    """Fixed-op polynomial inverse of volume_by_w (see _W_POLY note).

    End-to-end |w - w_exact| < 5e-6 in float32 (poly 3.2e-7 + cube-root
    seed error /8), an order tighter than the reference Newton's 2^-12.
    """
    v = jnp.asarray(v, jnp.float32)
    c = TWO_PI * (1.0 - v)
    mirrored = c > PI
    c_half = jnp.where(mirrored, TWO_PI - c, c)
    u = _cbrt_sq_bits(36.0 * c_half * c_half, iters=cbrt_iters)
    acc = jnp.full_like(u, _W_POLY[-1])
    for coef in _W_POLY[-2::-1]:
        acc = acc * u + coef
    return jnp.where(mirrored, -acc, acc)


def w_by_volume_kepler(v: jnp.ndarray, iters: int = 2) -> jnp.ndarray:
    """Fixed-op-count inverse of volume_by_w via Kepler's equation.

    Accuracy: |w_kepler - w_exact| < 1e-5 over v in [0, 1) with the
    default 2 Halley iterations — already at the float32 rounding floor
    (iterations 3 and 4 change nothing; validated against a float64
    bisection oracle) and comfortably inside the reference solver's own
    2^-12 Newton tolerance.
    """
    v = jnp.asarray(v, jnp.float32)
    c = TWO_PI * (1.0 - v)
    # Symmetry: x(2*pi - c) = 2*pi - x(c); solve on [0, pi] only.
    mirrored = c > PI
    c_half = jnp.where(mirrored, TWO_PI - c, c)
    x = _solve_kepler_half(c_half, iters)
    x = jnp.where(mirrored, TWO_PI - x, x)
    return jnp.cos(0.5 * x)


def direction_from_uniforms(
    u_w: jnp.ndarray,
    u_z: jnp.ndarray,
    u_fi: jnp.ndarray,
    *,
    method: str = "poly",
    kepler_iters: int = 2,
) -> Vec4:
    """Map three uniforms in [0,1) to a uniform direction on S^3.

    Follows shader.frag:153-158 call-for-call: u_w picks w through the
    inverse CDF, u_z picks z uniformly in [-r, r] (hat-box), u_fi the
    azimuth. The caller draws the uniforms from the counter RNG in this
    exact order to match the reference stream.
    """
    if method == "newton":
        w = w_by_volume_newton(u_w)
    elif method == "kepler":
        w = w_by_volume_kepler(u_w, iters=kepler_iters)
    elif method == "poly":
        w = w_by_volume_poly(u_w)
    else:
        raise ValueError(f"unknown method {method!r}")
    r = jnp.sqrt(jnp.maximum(1.0 - w * w, 0.0))
    z = (u_z * 2.0 - 1.0) * r
    rho = jnp.sqrt(jnp.maximum(r * r - z * z, 0.0))
    if method == "newton":
        # Oracle-parity mode: the exact library circular functions, like
        # the reference's cos/sin of the radian angle (shader.frag:128-129).
        fi = u_fi * TWO_PI
        sin_fi, cos_fi = jnp.sin(fi), jnp.cos(fi)
    else:
        # Production modes: evaluate both circular functions straight
        # from the turn fraction (one quadrant reduction, two small
        # polynomials — ops/fastmath.sincos_2pi, ~1e-7 = f32 floor).
        from fourd_ray_tracing_tpu.ops.fastmath import sincos_2pi

        sin_fi, cos_fi = sincos_2pi(u_fi)
    return Vec4(rho * cos_fi, rho * sin_fi, z, w)
