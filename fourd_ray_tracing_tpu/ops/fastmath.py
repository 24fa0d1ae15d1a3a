"""Inverse trigonometry and circular functions from elementary ops.

The render needs arccos for the sun's angular profile (shader.frag:454-468
computes the angle between the ray and the sun direction) and sin/cos for
the S^3 sampler. These implementations use only mul/add, sqrt, floor,
select and compare, which both XLA and the Pallas-Triton kernel lower,
are float32-accurate to ~1e-7 rad (f32 ulp scale), and are used by BOTH
the jnp renderer and the forward kernel so the two compute the same
ops.

atan core: odd minimax polynomial t*P(t^2) on [0, 1] (degree 9 in t^2,
max error 7.6e-9 in f64, ~7.5e-8 evaluated in f32), range-reduced by
atan(t) = pi/2 - atan(1/t) for t > 1.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_HALF_PI = np.float32(np.pi / 2)
_PI = np.float32(np.pi)

# atan(t)/t as a polynomial in u = t^2, u in [0, 1] (see module docstring).
_ATAN_COEFFS = tuple(
    np.float32(c)
    for c in (
        0.9999999981420136,
        -0.3333329279633544,
        0.19998532570283645,
        -0.1426489237473346,
        0.10958363839007743,
        -0.08427634966170072,
        0.05845791831595609,
        -0.0317506334697238,
        0.011257683716639311,
        -0.0018775736582807062,
    )
)


def _atan_unit(t: jnp.ndarray) -> jnp.ndarray:
    """atan(t) for t in [0, 1] (Horner over u = t^2)."""
    u = t * t
    acc = jnp.full_like(u, _ATAN_COEFFS[-1])
    for c in _ATAN_COEFFS[-2::-1]:
        acc = acc * u + c
    return acc * t


def arctan(x: jnp.ndarray) -> jnp.ndarray:
    """atan(x) over the full real line."""
    ax = jnp.abs(x)
    big = ax > 1.0
    # reciprocal guarded against 0 on the small branch (unused there)
    inv = 1.0 / jnp.where(big, ax, 1.0)
    t = jnp.where(big, inv, ax)
    core = _atan_unit(t)
    res = jnp.where(big, _HALF_PI - core, core)
    return jnp.where(x < 0.0, -res, res)


def arctan2(y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """atan2(y, x) with standard quadrant conventions."""
    safe_x = jnp.where(x == 0.0, 1.0, x)
    base = arctan(y / safe_x)
    # x > 0: base; x < 0: base +/- pi by sign of y; x == 0: +/- pi/2.
    res = jnp.where(
        x > 0.0,
        base,
        jnp.where(
            x < 0.0,
            jnp.where(y < 0.0, base - _PI, base + _PI),
            jnp.where(y < 0.0, -_HALF_PI, _HALF_PI),
        ),
    )
    return res


def arccos(x: jnp.ndarray) -> jnp.ndarray:
    """acos(x) for x in [-1, 1] via atan2(sqrt(1-x^2), x).

    sqrt((1-x)(1+x)) keeps full precision near |x| = 1 (where the sun
    disk's center lands); out-of-range inputs clamp.
    """
    x = jnp.clip(x, -1.0, 1.0)
    s = jnp.sqrt(jnp.maximum((1.0 - x) * (1.0 + x), 0.0))
    return arctan2(s, x)


def arcsin(x: jnp.ndarray) -> jnp.ndarray:
    """asin(x) = pi/2 - acos(x)."""
    return _HALF_PI - arccos(x)


# sin(2*pi*x)/x and cos(2*pi*x) as polynomials in u = x^2 over the
# quadrant-reduced range x in [-1/8, 1/8] (Chebyshev fits, max f32
# evaluation error ~1e-7 — the float32 rounding floor; fit residual in
# f64 is <1e-10).
_SIN2PI_COEFFS = tuple(
    np.float32(c)
    for c in (
        6.2831853071e00,
        -4.1341702134e01,
        8.1605201758e01,
        -7.6697740910e01,
        4.1472862296e01,
    )
)
_COS2PI_COEFFS = tuple(
    np.float32(c)
    for c in (
        9.9999999990e-01,
        -1.9739208617e01,
        6.4939310978e01,
        -8.5442625666e01,
        5.9220223797e01,
    )
)


def _horner(u: jnp.ndarray, coeffs) -> jnp.ndarray:
    acc = jnp.full_like(u, coeffs[-1])
    for c in coeffs[-2::-1]:
        acc = acc * u + c
    return acc


def sincos_2pi(u: jnp.ndarray):
    """(sin(2*pi*u), cos(2*pi*u)) for u in turns, sharing one quadrant
    reduction and two small Horner polynomials.

    The production S^3 sampler's azimuth is a uniform draw in [0, 1)
    scaled by 2*pi (shader.frag:156-158); evaluating both circular
    functions from the TURN fraction skips the generic large-angle
    argument reduction XLA's sin/cos must perform and costs ~30 ops
    for the pair. Max error ~1e-7 (f32 floor) — far inside the
    reference's own 2^-12 sampler tolerance. Used only by the production
    sampler modes ("poly"/"kepler"); the oracle-parity "newton" mode
    keeps jnp.sin/jnp.cos (ops/sampler.py).
    """
    u = jnp.asarray(u, jnp.float32)
    # Quadrant: n = nearest integer to 4u; x = u - n/4 in [-1/8, 1/8]
    # (turns). floor(v + 0.5) instead of round: Triton has no round, and
    # at an exact tie both quadrants give the same value.
    n = jnp.floor(u * 4.0 + 0.5)
    x = u - n * 0.25
    u2 = x * x
    s0 = x * _horner(u2, _SIN2PI_COEFFS)  # sin(2*pi*x)
    c0 = _horner(u2, _COS2PI_COEFFS)      # cos(2*pi*x)
    q = n - 4.0 * jnp.floor(n * 0.25)     # n mod 4 in {0, 1, 2, 3}
    odd = jnp.logical_or(q == 1.0, q == 3.0)
    # sin(2*pi*u) by quadrant: [s0, c0, -s0, -c0]; cos: [c0, -s0, -c0, s0].
    sin_base = jnp.where(odd, c0, s0)
    cos_base = jnp.where(odd, s0, c0)
    sin = jnp.where(q >= 2.0, -sin_base, sin_base)
    cos = jnp.where(
        jnp.logical_or(q == 1.0, q == 2.0), -cos_base, cos_base
    )
    return sin, cos
