"""4D camera: spherical angles -> orthonormal basis, movement, views.

Re-expresses the reference camera layer (src/controls.cpp) as pure jnp
functions over traced scalars, so camera parameters are differentiable
and view bases batch over a leading axis.

The reference builds the basis from identity (forward=y, top=z, right=x,
w=w) by three Givens rotations (src/controls.cpp:72-86):

    rotate(psi, top, w)      -> verticalTop saved before fi/te
    rotate(fi, forward, right) -> horizontalForward/Right saved
    rotate(te, forward, top)

Movement uses the *partially rotated* bases (horizontalForward etc.,
src/controls.cpp:118-134) so W/S stay in the horizontal plane regardless
of pitch. Angle normalization (src/controls.cpp:41-49): fi wraps to
(-pi, pi], te clamps to [-pi/2, pi/2], psi wraps or clamps to a
configured range (properties.txt constrain_psi_range).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

from fourd_ray_tracing_tpu.ops.vec4 import Vec4

PI = np.float32(np.pi)
# width/height ratio of windows and camera film (inc/util/math.h:9).
GOLDEN = np.float32(1.61803399)


class Orientation(NamedTuple):
    """Full + partially-rotated camera bases (inc/controls.h:9-14)."""

    forward: Vec4
    top: Vec4
    right: Vec4
    w_drct: Vec4
    horizontal_forward: Vec4
    horizontal_right: Vec4
    vertical_top: Vec4


def rotate_pair(angle, x: Vec4, y: Vec4):
    """Rotate two basis vectors in their shared plane (src/controls.cpp:64-69)."""
    sin_a = jnp.sin(angle)
    cos_a = jnp.cos(angle)
    return x * cos_a + y * sin_a, x * (-sin_a) + y * cos_a


def orientation_from_angles(fi, te, psi) -> Orientation:
    """Basis from yaw fi, pitch te, 4D roll psi (src/controls.cpp:72-86)."""
    forward = Vec4.of(0.0, 1.0, 0.0, 0.0)
    top = Vec4.of(0.0, 0.0, 1.0, 0.0)
    right = Vec4.of(1.0, 0.0, 0.0, 0.0)
    w_drct = Vec4.of(0.0, 0.0, 0.0, 1.0)

    top, w_drct = rotate_pair(psi, top, w_drct)
    vertical_top = top

    forward, right = rotate_pair(fi, forward, right)
    horizontal_forward = forward
    horizontal_right = right

    forward, top = rotate_pair(te, forward, top)

    return Orientation(
        forward, top, right, w_drct,
        horizontal_forward, horizontal_right, vertical_top,
    )


def normalize_angle(angle):
    """Wrap to (-pi, pi] (src/util/math.cpp:24-28)."""
    wrapped = jnp.mod(jnp.asarray(angle, jnp.float32) + PI, 2.0 * PI) - PI
    return jnp.where(wrapped <= -PI, wrapped + 2.0 * PI, wrapped)


def pull_into_range(value, center, radius):
    """Clamp to [center - radius, center + radius] (src/util/math.cpp:19-22)."""
    return jnp.clip(value, center - radius, center + radius)


class CameraAngles(NamedTuple):
    """fi/te/psi with the reference's normalization semantics
    (SphOrientation, src/controls.cpp:25-55)."""

    fi: jnp.ndarray
    te: jnp.ndarray
    psi: jnp.ndarray

    def normalized(self, psi_center=None, psi_radius=None) -> "CameraAngles":
        fi = normalize_angle(self.fi)
        te = pull_into_range(self.te, 0.0, PI / 2)
        if psi_center is not None:
            psi = pull_into_range(self.psi, psi_center, psi_radius)
        else:
            psi = normalize_angle(self.psi)
        return CameraAngles(fi, te, psi)


class Camera(NamedTuple):
    """Camera state uploaded to the renderer each frame.

    focus / vec_to_mtr / bases mirror the uniforms of shader.frag:16-19;
    mtr size follows main.cpp:37-38 (width = height * GOLDEN).
    """

    focus: Vec4
    vec_to_mtr: Vec4     # forward * focus_to_matrix_distance (main.cpp:90)
    top: Vec4            # per-view; may carry a leading view axis
    right: Vec4
    mtr_width: jnp.ndarray
    mtr_height: jnp.ndarray


def camera_from_state(
    focus: Vec4,
    angles: CameraAngles,
    focus_to_matrix_distance: float,
    matrix_height: float,
    view: str = "yxz",
) -> Camera:
    orient = orientation_from_angles(angles.fi, angles.te, angles.psi)
    top, right = view_basis(orient, view)
    mtr_h = jnp.asarray(matrix_height, jnp.float32)
    return Camera(
        focus=focus,
        vec_to_mtr=orient.forward * jnp.asarray(focus_to_matrix_distance, jnp.float32),
        top=top,
        right=right,
        mtr_width=mtr_h * GOLDEN,
        mtr_height=mtr_h,
    )


def view_basis(orient: Orientation, view: str):
    """(top, right) for one of the three orthogonal 3D sections
    (src/windows/three_window_group.cpp:42-46)."""
    if view == "yxz":       # main window
        return orient.top, orient.right
    if view == "ywz":       # w replaces x
        return orient.top, orient.w_drct
    if view == "yxw":       # w replaces z
        return orient.w_drct, orient.right
    raise ValueError(f"unknown view {view!r}")


VIEWS_ALL: Sequence[str] = ("yxz", "ywz", "yxw")


def batched_view_bases(orient: Orientation, views: Sequence[str] = VIEWS_ALL):
    """Stack view bases along a leading axis: the batched replacement
    for three sequential window draws — one launch renders all sections."""
    tops, rights = [], []
    for v in views:
        t, r = view_basis(orient, v)
        tops.append(t)
        rights.append(r)
    stack = lambda vs: Vec4(
        jnp.stack([v.x for v in vs]),
        jnp.stack([v.y for v in vs]),
        jnp.stack([v.z for v in vs]),
        jnp.stack([v.w for v in vs]),
    )
    return stack(tops), stack(rights)


class MoveKeys(NamedTuple):
    """Held-key state for 8-direction movement (src/controls.cpp:95-100)."""

    forward: bool = False
    back: bool = False
    right: bool = False
    left: bool = False
    top: bool = False
    down: bool = False
    w_pos: bool = False
    w_neg: bool = False


def move_focus(
    focus: Vec4, orient: Orientation, keys: MoveKeys, seconds, speed
) -> tuple[Vec4, bool]:
    """Translate the focus along the movement bases (src/controls.cpp:118-134).

    Returns (new_focus, moved): ``moved`` resets the accumulation counter
    exactly when the reference would (controls.cpp:132).
    """
    zero = Vec4.of(0.0, 0.0, 0.0, 0.0)
    drct = zero
    pairs = (
        (keys.forward, keys.back, orient.horizontal_forward),
        (keys.top, keys.down, orient.vertical_top),
        (keys.right, keys.left, orient.horizontal_right),
        (keys.w_pos, keys.w_neg, orient.w_drct),
    )
    for pos, neg, basis in pairs:
        if pos:
            drct = drct + basis
        if neg:
            drct = drct - basis
    from fourd_ray_tracing_tpu.ops.vec4 import length

    norm = length(drct)
    moved = bool(norm > 0.0) if isinstance(norm, (float, int)) else norm > 0.0
    scale = jnp.where(norm > 0.0, seconds * speed / jnp.maximum(norm, 1e-30), 0.0)
    return focus + drct * scale, moved
