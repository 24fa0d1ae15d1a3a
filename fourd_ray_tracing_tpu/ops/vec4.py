"""Structure-of-arrays 4D/3D vector types.

The reference keeps 4-vectors as GLSL ``vec4`` / SFML ``sf::Glsl::Vec4``
(math helpers at src/util/math.cpp:6-14). Here the layout is
structure-of-arrays: each component is its own array of any shape, so
every vector op is a plain elementwise op over pixel-shaped data —
no gathers, no awkward trailing dims of 4. The same code runs unchanged
in plain jnp (oracle renderer, any backend) and inside Pallas kernels.

Both types are NamedTuples, hence pytrees: they can be jit arguments,
carried through `lax` control flow and differentiated through.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp

Scalar = Union[jnp.ndarray, float, int]


class Vec3(NamedTuple):
    """SoA 3-vector (used for light / color, like GLSL vec3)."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    @staticmethod
    def full(value: Scalar, like: jnp.ndarray | None = None) -> "Vec3":
        if like is None:
            v = jnp.asarray(value, jnp.float32)
            return Vec3(v, v, v)
        v = jnp.full_like(like, value)
        return Vec3(v, v, v)

    @staticmethod
    def of(x: Scalar, y: Scalar, z: Scalar) -> "Vec3":
        return Vec3(*(jnp.asarray(c, jnp.float32) for c in (x, y, z)))

    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, o: Union["Vec3", Scalar]) -> "Vec3":
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def where(self, mask: jnp.ndarray, other: "Vec3") -> "Vec3":
        """Elementwise select: mask ? self : other."""
        return Vec3(
            jnp.where(mask, self.x, other.x),
            jnp.where(mask, self.y, other.y),
            jnp.where(mask, self.z, other.z),
        )

    def stack(self, axis: int = -1) -> jnp.ndarray:
        return jnp.stack([self.x, self.y, self.z], axis=axis)

    @staticmethod
    def unstack(a: jnp.ndarray, axis: int = -1) -> "Vec3":
        parts = jnp.split(a, 3, axis=axis)
        return Vec3(*(p.squeeze(axis) for p in parts))


class Vec4(NamedTuple):
    """SoA 4-vector (positions/directions in R^4, like GLSL vec4)."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray
    w: jnp.ndarray

    @staticmethod
    def of(x: Scalar, y: Scalar, z: Scalar, w: Scalar) -> "Vec4":
        return Vec4(*(jnp.asarray(c, jnp.float32) for c in (x, y, z, w)))

    @staticmethod
    def zeros(like: jnp.ndarray) -> "Vec4":
        z = jnp.zeros_like(like)
        return Vec4(z, z, z, z)

    def __add__(self, o: "Vec4") -> "Vec4":
        return Vec4(self.x + o.x, self.y + o.y, self.z + o.z, self.w + o.w)

    def __sub__(self, o: "Vec4") -> "Vec4":
        return Vec4(self.x - o.x, self.y - o.y, self.z - o.z, self.w - o.w)

    def __neg__(self) -> "Vec4":
        return Vec4(-self.x, -self.y, -self.z, -self.w)

    def __mul__(self, s: Scalar) -> "Vec4":
        return Vec4(self.x * s, self.y * s, self.z * s, self.w * s)

    __rmul__ = __mul__

    def where(self, mask: jnp.ndarray, other: "Vec4") -> "Vec4":
        """Elementwise select: mask ? self : other."""
        return Vec4(
            jnp.where(mask, self.x, other.x),
            jnp.where(mask, self.y, other.y),
            jnp.where(mask, self.z, other.z),
            jnp.where(mask, self.w, other.w),
        )

    def stack(self, axis: int = -1) -> jnp.ndarray:
        return jnp.stack([self.x, self.y, self.z, self.w], axis=axis)

    @staticmethod
    def unstack(a: jnp.ndarray, axis: int = -1) -> "Vec4":
        parts = jnp.split(a, 4, axis=axis)
        return Vec4(*(p.squeeze(axis) for p in parts))


def dot(a: Vec4, b: Vec4) -> jnp.ndarray:
    """4D dot product (src/util/math.cpp:12, shader.frag dot())."""
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w


def length(a: Vec4) -> jnp.ndarray:
    return jnp.sqrt(dot(a, a))


def normalize(a: Vec4) -> Vec4:
    return a * (1.0 / length(a))


def reflect(d: Vec4, n: Vec4) -> Vec4:
    """GLSL reflect(): d - 2*dot(d,n)*n (used at shader.frag:489)."""
    return d - n * (2.0 * dot(d, n))


def redirect(v: Vec4, n: Vec4) -> Vec4:
    """Flip v into the hemisphere of n if it points inward (shader.frag:82-85)."""
    d = dot(v, n)
    flipped = v - n * (2.0 * d)
    return v.where(d >= 0.0, flipped)


def vec_in_space(v: Vec4, norm: Vec4) -> Vec4:
    """Remove the component of v collinear with norm (shader.frag:53)."""
    return v - norm * dot(v, norm)


def vec_to_space(point: Vec4, space_point: Vec4, space_norm: Vec4) -> Vec4:
    """Vector from point to the hyperplane {space_point, space_norm} (shader.frag:64-66)."""
    return space_norm * dot(space_point - point, space_norm)


def point_in_space(point: Vec4, space_point: Vec4, space_norm: Vec4) -> Vec4:
    """Project a point onto a hyperplane (shader.frag:69-71)."""
    return point + vec_to_space(point, space_point, space_norm)
