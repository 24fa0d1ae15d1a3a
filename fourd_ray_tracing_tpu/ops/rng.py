"""Counter-based per-pixel PRNG, bit-compatible with the reference shader.

The reference (shader.frag:88-121) derives every random number from

    hash(pixel_bits ^ call_counter ^ frame_seed)

where ``pixel_bits`` mixes the IEEE-754 bit patterns of the normalized
screen coordinate, the ``call_counter`` advances by ``0x79A010A9`` per
call, and ``hash`` is a 6-round shift/xor/add mixer. Because the stream
is indexed by *absolute pixel id* and *call index* — never by any
execution order — the very same construction is what makes rendering
deterministic across tiling, vectorization and device sharding:
shard the rays any way you like, the image is bit-identical (SURVEY §4.6).

All functions are pure and shape-polymorphic; they run identically in
plain jnp and inside Pallas kernels. State is an explicit uint32 counter
carried by the caller (one per ray/pixel lane), advanced only when the
reference would actually call ``rand()`` — the reference's call count is
data-dependent (diffuse bounces draw 3 extras, shader.frag:153-158), so
masked lanes must not advance their counters.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Per-call counter increment (shader.frag:105).
CALL_DELTA = np.uint32(0x79A010A9)
_MANTISSA = np.uint32(0x007FFFFF)
_ONE_BITS = np.uint32(0x3F800000)


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, jnp.uint32)


def hash_u32(x: jnp.ndarray) -> jnp.ndarray:
    """The 6-round integer mixer (shader.frag:94-102).

    uint32 adds wrap modulo 2^32, matching GLSL unsigned arithmetic.
    """
    x = _u32(x)
    x = x + (x << 10)
    x = x ^ (x >> 6)
    x = x + (x << 3)
    x = x ^ (x >> 11)
    x = x + (x << 15)
    x = x ^ (x >> 9)
    return x


def float_bits(f: jnp.ndarray) -> jnp.ndarray:
    """IEEE-754 bit pattern of a float32 (GLSL floatBitsToUint)."""
    return jax.lax.bitcast_convert_type(jnp.asarray(f, jnp.float32), jnp.uint32)


def pixel_stream_bits(scr_x: jnp.ndarray, scr_y: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel decorrelation word from normalized screen coords.

    Mirrors shader.frag:106-107: ``bits(x) ^ (bits(y) << 9)`` over the
    *normalized* coordinate (pixel center / resolution). Computed once
    per pixel and reused for every draw of the frame.
    """
    return float_bits(scr_x) ^ (float_bits(scr_y) << 9)


def random_uint(pixel_bits: jnp.ndarray, seed: jnp.ndarray, counter: jnp.ndarray):
    """One draw of raw bits; returns (bits, advanced_counter).

    shader.frag:104-108: the counter advances by CALL_DELTA *before*
    hashing, and the frame seed is xored in twice (once via the counter's
    initial value, once directly) — we replicate by initializing
    ``counter`` to ``seed`` (see `init_counter`) and xoring seed here.
    """
    counter = _u32(counter) + CALL_DELTA
    bits = hash_u32(_u32(pixel_bits) ^ counter ^ _u32(seed))
    return bits, counter


def uniform01(pixel_bits: jnp.ndarray, seed: jnp.ndarray, counter: jnp.ndarray):
    """One uniform float in [0, 1); returns (value, advanced_counter).

    Uses the reference's mantissa trick (shader.frag:111-118): keep 23
    random mantissa bits, OR in the exponent of 1.0 to get a float in
    [1, 2), subtract 1.
    """
    bits, counter = random_uint(pixel_bits, seed, counter)
    bits = (bits & _MANTISSA) | _ONE_BITS
    value = jax.lax.bitcast_convert_type(bits, jnp.float32) - 1.0
    return value, counter


def init_counter(seed: jnp.ndarray, shape=()) -> jnp.ndarray:
    """Fresh per-lane counters for a frame (shader.frag:90-92:
    ``rand_iter_seed = uint_seed``)."""
    return jnp.broadcast_to(_u32(seed), shape)


def masked_uniform01(pixel_bits, seed, counter, active):
    """uniform01 that only advances counters of ``active`` lanes.

    Vector code executes all lanes; the reference's scalar shader only calls
    rand() on live code paths. Advancing only active lanes keeps the
    per-lane call index equal to the reference's sequential call count,
    which is what makes the vectorized renderer bit-match the oracle.
    """
    value, new_counter = uniform01(pixel_bits, seed, counter)
    counter = jnp.where(active, new_counter, counter)
    return value, counter
