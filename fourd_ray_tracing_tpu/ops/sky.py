"""Sky / sun environment light and tone mapping.

Mirrors shader.frag:404-468 (sun disk with nonlinear edge profile over a
constant sky) and shader.frag:509-511 (the Reinhard-style light->color
map). Scenes may disable the environment entirely (the room scene
overrides final_light to black, scenes/Комната со сферой.frag:37-39) —
expressed here by an ``enabled`` flag so it stays a traced value.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from fourd_ray_tracing_tpu.ops.fastmath import arccos
from fourd_ray_tracing_tpu.ops.vec4 import Vec3, Vec4, dot, length


class Sun(NamedTuple):
    """sun_properties (shader.frag:404-409)."""

    drct: Vec4          # direction toward the sun (not necessarily unit)
    angular_size: jnp.ndarray
    light: Vec3         # emitted light
    sharpness: jnp.ndarray  # 1 = hard disk, ->0 = blurred


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Environment:
    sun: Sun
    sky_light: Vec3
    # Static (non-traced): the room scene compiles the sky away entirely,
    # like its final_light override to vec3(0).
    enabled: bool = dataclasses.field(metadata=dict(static=True), default=True)


def final_light(env: Environment | None, ray_d: Vec4) -> Vec3:
    """Light for a ray escaping to infinity (shader.frag:454-468).

    deviation = angle(d, sun.drct); inside the sun's angular disk the
    sun and sky blend with the edge profile
        k = (s^2*k/(1 - s*k) + 1) * (1 - k)
    (shader.frag:462-463), else plain sky light.
    """
    if env is None or not env.enabled:
        return Vec3.full(0.0, like=ray_d.x)
    cos_dev = dot(ray_d, env.sun.drct) / (length(ray_d) * length(env.sun.drct))
    cos_dev = jnp.clip(cos_dev, -1.0, 1.0)
    # Double-where keeps d(arccos)/dx finite at |cos|=1 (exact sun-center
    # hits would otherwise NaN the scene gradient).
    interior = jnp.abs(cos_dev) < 1.0
    # fastmath.arccos: elementary ops only, ~1e-7 rad accurate, shared
    # by the jnp and kernel paths.
    dev_safe = arccos(jnp.where(interior, cos_dev, 0.0))
    deviation = jnp.where(
        interior, dev_safe, jnp.where(cos_dev > 0.0, 0.0, jnp.pi)
    ).astype(jnp.float32)
    in_sun = deviation < env.sun.angular_size
    k = deviation / env.sun.angular_size
    s = env.sun.sharpness
    # The reference divides by (1 - s*k) unguarded (shader.frag:463) and
    # can 0-divide at s*k == 1 (sharpness-1 ray exactly on the disk edge);
    # here that NaN would also poison the scene *gradient* through the sun
    # parameters, so floor the denominator. Inside the disk k < 1, so for
    # s < 1 the guard never triggers and the forward value is unchanged.
    denom = 1.0 - s * k
    k = (s * s * k / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom) + 1.0) * (1.0 - k)
    blended = env.sun.light * k + env.sky_light * (1.0 - k)
    sky = Vec3(
        jnp.broadcast_to(env.sky_light.x, ray_d.x.shape),
        jnp.broadcast_to(env.sky_light.y, ray_d.x.shape),
        jnp.broadcast_to(env.sky_light.z, ray_d.x.shape),
    )
    return blended.where(in_sun, sky)


def light_to_color(light: Vec3, coefficient) -> Vec3:
    """Tone map: 1 - 1/(c*l + 1) (shader.frag:509-511)."""
    return Vec3(
        1.0 - 1.0 / (coefficient * light.x + 1.0),
        1.0 - 1.0 / (coefficient * light.y + 1.0),
        1.0 - 1.0 / (coefficient * light.z + 1.0),
    )
