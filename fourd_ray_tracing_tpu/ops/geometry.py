"""Ray-primitive intersections in R^4, batched SoA, mask-based.

Each function mirrors the behavior of a reference kernel sub-component
(SURVEY §2.2, shader.frag:163-400) but is written for vector lanes: instead
of early returns it computes a ``hit`` mask alongside distance/normal,
and scenes fold candidates with `closest` (shader.frag:181-185). All
branches become `jnp.where` selects, so a block of rays runs as
straight-line elementwise code with no divergent branches.

Primitive parameters are scalars or broadcastable arrays — they stay
differentiable JAX values, which is what makes the whole renderer
differentiable w.r.t. scene geometry.

Conventions preserved from the reference (bit-for-bit decisions):
* miss thresholds use SMALL_FLOAT exactly where the shader does;
* `outer=False` makes front walls transparent from outside
  (shader.frag:196);
* the duocylinder clips its second cylinder against ``cylinder2.r``
  where symmetry suggests ``cylinder1.r`` — replicated deliberately
  (shader.frag:290, SURVEY C6i fidelity note);
* hypercube cell tests keep first-hit-in-order semantics, not closest
  (shader.frag:394-400).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from fourd_ray_tracing_tpu.ops.sampler import SMALL_FLOAT
from fourd_ray_tracing_tpu.ops.vec4 import (
    Vec3,
    Vec4,
    dot,
    length,
    point_in_space,
    vec_in_space,
)


def _safe_length(v: Vec4) -> jnp.ndarray:
    """|v| with a denormal-scale floor inside the sqrt.

    sqrt has an infinite derivative at 0; under masked-lane execution a
    zero-length vector on a MISS lane would turn the lane's (zero)
    cotangent into 0 * inf = NaN and poison the whole image gradient —
    the standard double-where trap. The 1e-37 floor is invisible in
    float32 for any |v|^2 > ~1e-30 and keeps the derivative finite.
    """
    return jnp.sqrt(dot(v, v) + 1e-37)


def _safe_sqrt_pos(x: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """sqrt(x) where valid (x > 0 there), exactly 0.0 elsewhere, with
    finite gradients on invalid lanes (double-where pattern)."""
    safe = jnp.sqrt(jnp.where(valid, x, 1.0))
    return jnp.where(valid, safe, 0.0)


class Material(NamedTuple):
    """Emissive-diffuse-mirror material (shader.frag:163-167)."""

    glow: jnp.ndarray       # emissive strength
    refl_prob: jnp.ndarray  # probability of mirror reflection
    color: Vec3             # albedo / emission tint

    @staticmethod
    def of(glow: float, refl_prob: float, color: tuple) -> "Material":
        return Material(
            jnp.asarray(glow, jnp.float32),
            jnp.asarray(refl_prob, jnp.float32),
            Vec3.of(*color),
        )


class Intersection(NamedTuple):
    """SoA hit record (shader.frag:171-176) with inlined material."""

    hit: jnp.ndarray
    dist: jnp.ndarray
    norm: Vec4
    glow: jnp.ndarray
    refl_prob: jnp.ndarray
    color: Vec3

    def where(self, mask: jnp.ndarray, other: "Intersection") -> "Intersection":
        return Intersection(
            (mask & self.hit) | (~mask & other.hit),
            jnp.where(mask, self.dist, other.dist),
            self.norm.where(mask, other.norm),
            jnp.where(mask, self.glow, other.glow),
            jnp.where(mask, self.refl_prob, other.refl_prob),
            self.color.where(mask, other.color),
        )


def miss_like(ref: jnp.ndarray) -> Intersection:
    """NOT_INTERSECT (shader.frag:178) broadcast to the ray batch shape.

    The all-false mask is a comparison, not a bool constant (XLA folds
    the compare anyway).
    """
    zero = jnp.zeros_like(ref)
    return Intersection(
        zero > jnp.ones_like(ref),
        zero,
        Vec4(zero, zero, zero, zero),
        zero,
        zero,
        Vec3(zero, zero, zero),
    )


def _masked(hit: jnp.ndarray, dist, norm: Vec4, material: Material, ref) -> Intersection:
    """Assemble a record, broadcasting material over the ray batch."""
    shape = hit.shape
    return Intersection(
        hit,
        jnp.broadcast_to(dist, shape),
        Vec4(*(jnp.broadcast_to(c, shape) for c in norm)),
        jnp.broadcast_to(material.glow, shape),
        jnp.broadcast_to(material.refl_prob, shape),
        Vec3(*(jnp.broadcast_to(c, shape) for c in material.color)),
    )


def closest(a: Intersection, b: Intersection) -> Intersection:
    """Nearer valid hit; ties keep ``b`` (shader.frag:181-185 semantics:
    closest(new, acc) keeps acc unless new is strictly nearer)."""
    take_a = jnp.logical_and(
        a.hit, jnp.logical_or(jnp.logical_not(b.hit), a.dist < b.dist)
    )
    return a.where(take_a, b)


# --- Hypersphere (shader.frag:189-221) -----------------------------------

def sphere_intersection(
    center: Vec4,
    r,
    material: Material,
    ray_o: Vec4,
    ray_d: Vec4,
    outer: bool = True,
) -> Intersection:
    """Ray / 3-sphere intersection.

    The reference solves this with an acos/asin angle chain
    (shader.frag:197-221); here we use the algebraically identical
    quadratic form (law of cosines collapses to it), which costs one
    sqrt instead of four transcendentals and is exactly equivalent in
    reals; `sphere_intersection_trig` keeps the literal formulation for
    fidelity testing. Semantics preserved:

    * outside ray receding (len_po >= r and b < 0) -> miss (:206);
    * tangent or beyond (discriminant <= 0 <=> sin_oap >= 1) -> miss (:213);
    * outer hit from outside -> near root, else far root (:215-216);
    * degenerate origin-at-center (len_po < SMALL_FLOAT) -> b treated 0 (:202);
    * normal points (center-hit)/r, flipped when hit from outside (:218-219).
    """
    po = center - ray_o
    l2 = dot(po, po)
    l = _safe_length(po)
    b = dot(po, ray_d)
    degenerate = l < SMALL_FLOAT
    b = jnp.where(degenerate, 0.0, b)
    miss_receding = jnp.logical_and(
        jnp.logical_not(degenerate), jnp.logical_and(l >= r, b < 0.0)
    )
    disc = r * r - (l2 - b * b)
    miss_tangent = disc <= 0.0
    s = _safe_sqrt_pos(disc, jnp.logical_not(miss_tangent))
    # ``outer`` is static — resolve at trace time rather than folding a
    # literal bool into logical_and.
    use_near = (l > r) if outer else (l < -jnp.inf)
    dist = jnp.where(use_near, b - s, b + s)
    hit = jnp.logical_not(jnp.logical_or(miss_receding, miss_tangent))
    hit_point = ray_o + ray_d * dist
    norm = (center - hit_point) * (1.0 / r)
    norm = (-norm).where(use_near, norm)
    return _masked(hit, dist, norm, material, l)


def sphere_intersection_trig(
    center: Vec4,
    r,
    material: Material,
    ray_o: Vec4,
    ray_d: Vec4,
    outer: bool = True,
) -> Intersection:
    """Literal re-expression of the reference's trigonometric solution
    (shader.frag:197-221), for parity/fidelity testing only."""
    po = center - ray_o
    l = length(po)
    degenerate = l < SMALL_FLOAT
    dot_pord = dot(po, ray_d)
    miss_receding = jnp.logical_and(
        jnp.logical_not(degenerate), jnp.logical_and(l >= r, dot_pord < 0.0)
    )
    cos_opa = jnp.where(degenerate, 0.0, jnp.clip(dot_pord / jnp.maximum(l, 1e-30), -1.0, 1.0))
    angle_opa = jnp.arccos(cos_opa)
    sin_oap = l * jnp.sin(angle_opa) / r
    miss_tangent = sin_oap >= 1.0
    angle_oap = jnp.arcsin(jnp.clip(sin_oap, -1.0, 1.0))
    use_near = jnp.logical_and(bool(outer), l > r)
    angle_oap = jnp.where(use_near, np.float32(np.pi) - angle_oap, angle_oap)
    angle_aop = np.float32(np.pi) - angle_opa - angle_oap
    dist = jnp.sqrt(
        jnp.maximum(r * r + l * l - 2.0 * r * l * jnp.cos(angle_aop), 0.0)
    )
    hit = jnp.logical_not(jnp.logical_or(miss_receding, miss_tangent))
    norm = (center - (ray_o + ray_d * dist)) * (1.0 / r)
    norm = (-norm).where(use_near, norm)
    return _masked(hit, dist, norm, material, l)


# --- Hyperplane ("space", shader.frag:225-239) ---------------------------

def space_intersection(
    point: Vec4, norm: Vec4, material: Material, ray_o: Vec4, ray_d: Vec4
) -> Intersection:
    """Double-sided hyperplane; normal auto-oriented toward the ray origin."""
    v = point - ray_o
    dot_vn = dot(v, norm)
    sgn = jnp.sign(dot_vn)
    drct_h = norm * sgn
    cos_dh = dot(drct_h, ray_d)
    hit = cos_dh >= SMALL_FLOAT
    dist = jnp.abs(dot_vn) / jnp.where(hit, cos_dh, 1.0)
    return _masked(hit, dist, -drct_h, material, dot_vn)


# --- Infinite 4D cylinder (shader.frag:243-275) --------------------------

def cylinder_intersection(
    point: Vec4,
    axis1: Vec4,
    axis2: Vec4,
    r,
    material: Material,
    ray_o: Vec4,
    ray_d: Vec4,
    outer: bool = True,
    trig: bool = False,
) -> Intersection:
    """Cylinder infinite along two orthogonal axes: project the ray into
    the 2-plane orthogonal to both axes, circle-intersect there, un-scale
    the distance by the projected direction length (shader.frag:251-267).

    ``trig`` switches the inner circle test to the reference's literal
    trigonometric sphere solution (fidelity/oracle mode)."""
    o1 = point_in_space(ray_o, point, axis1)
    d1 = vec_in_space(ray_d, axis1)
    miss1 = _safe_length(d1) < SMALL_FLOAT

    o12 = point_in_space(o1, point, axis2)
    d12 = vec_in_space(d1, axis2)
    d12_len = _safe_length(d12)
    miss2 = d12_len < SMALL_FLOAT
    inv_len = 1.0 / jnp.where(miss2, 1.0, d12_len)
    d12_unit = d12 * inv_len

    sphere_fn = sphere_intersection_trig if trig else sphere_intersection
    inter = sphere_fn(point, r, material, o12, d12_unit, outer)
    hit = jnp.logical_and(
        inter.hit, jnp.logical_not(jnp.logical_or(miss1, miss2))
    )
    return inter._replace(hit=hit, dist=inter.dist * inv_len)


def dist_to_axes_plane(
    dist, ray_o: Vec4, ray_d: Vec4, point: Vec4, axis1: Vec4, axis2: Vec4
) -> jnp.ndarray:
    """Distance from the ray point at parameter ``dist`` to the cylinder's
    axis 2-plane (shader.frag:270-275)."""
    p = ray_o + ray_d * dist
    p1 = point_in_space(p, point, axis1)
    p12 = point_in_space(p1, point, axis2)
    return _safe_length(point - p12)


# --- Duocylinder: union of two axis-swapped cylinders (shader.frag:279-294)

class CylinderSpec(NamedTuple):
    point: Vec4
    axis1: Vec4
    axis2: Vec4
    r: jnp.ndarray
    material: Material


def cylinders_union_intersection(
    cyl1: CylinderSpec, cyl2: CylinderSpec, ray_o: Vec4, ray_d: Vec4,
    trig: bool = False,
) -> Intersection:
    """Each cylinder's hit is kept only if it lies within the *other*
    cylinder's radius. NOTE: the second clip tests against cyl2.r, not
    cyl1.r — verbatim reference behavior (shader.frag:290, SURVEY C6i)."""
    inter1 = cylinder_intersection(
        cyl1.point, cyl1.axis1, cyl1.axis2, cyl1.r, cyl1.material, ray_o, ray_d,
        True, trig,
    )
    d1 = dist_to_axes_plane(inter1.dist, ray_o, ray_d, cyl2.point, cyl2.axis1, cyl2.axis2)
    inter1 = inter1._replace(hit=jnp.logical_and(inter1.hit, d1 <= cyl2.r))

    inter2 = cylinder_intersection(
        cyl2.point, cyl2.axis1, cyl2.axis2, cyl2.r, cyl2.material, ray_o, ray_d,
        True, trig,
    )
    d2 = dist_to_axes_plane(inter2.dist, ray_o, ray_d, cyl1.point, cyl1.axis1, cyl1.axis2)
    inter2 = inter2._replace(hit=jnp.logical_and(inter2.hit, d2 <= cyl2.r))

    return closest(inter1, inter2)


# --- Tiger (shader.frag:297-341) -----------------------------------------

class TigerSpec(NamedTuple):
    """Four cylinders built by init_tiger (shader.frag:303-314)."""

    inner_cyl1: CylinderSpec
    outer_cyl1: CylinderSpec
    inner_cyl2: CylinderSpec
    outer_cyl2: CylinderSpec


def make_tiger(
    point: Vec4,
    axis1: Vec4,
    axis2: Vec4,
    axis3: Vec4,
    axis4: Vec4,
    inner_r,
    outer_r,
    material1: Material,
    material2: Material,
) -> TigerSpec:
    inner_r = jnp.asarray(inner_r, jnp.float32)
    outer_r = jnp.asarray(outer_r, jnp.float32)
    return TigerSpec(
        CylinderSpec(point, axis1, axis2, inner_r, material1),
        CylinderSpec(point, axis1, axis2, outer_r, material1),
        CylinderSpec(point, axis3, axis4, inner_r, material2),
        CylinderSpec(point, axis3, axis4, outer_r, material2),
    )


def _tiger_face(
    cyl: CylinderSpec,
    outer_cyl: CylinderSpec,
    inner_cyl: CylinderSpec,
    ray_o: Vec4,
    ray_d: Vec4,
    outer: bool,
    trig: bool = False,
) -> Intersection:
    """One face: cylinder hit clipped to the [inner_r, outer_r] annulus of
    the other cylinder family (shader.frag:317-324)."""
    inter = cylinder_intersection(
        cyl.point, cyl.axis1, cyl.axis2, cyl.r, cyl.material, ray_o, ray_d,
        outer, trig,
    )
    d_out = dist_to_axes_plane(
        inter.dist, ray_o, ray_d, outer_cyl.point, outer_cyl.axis1, outer_cyl.axis2
    )
    d_in = dist_to_axes_plane(
        inter.dist, ray_o, ray_d, inner_cyl.point, inner_cyl.axis1, inner_cyl.axis2
    )
    keep = jnp.logical_and(d_out <= outer_cyl.r, d_in >= inner_cyl.r)
    return inter._replace(hit=jnp.logical_and(inter.hit, keep))


def tiger_intersection(
    tiger: TigerSpec, ray_o: Vec4, ray_d: Vec4, trig: bool = False
) -> Intersection:
    """Closest of the 8 face tests (4 cylinders x outer in {True, False},
    shader.frag:327-341)."""
    faces = []
    for cyl, ocyl, icyl in (
        (tiger.inner_cyl1, tiger.outer_cyl2, tiger.inner_cyl2),
        (tiger.outer_cyl1, tiger.outer_cyl2, tiger.inner_cyl2),
        (tiger.inner_cyl2, tiger.outer_cyl1, tiger.inner_cyl1),
        (tiger.outer_cyl2, tiger.outer_cyl1, tiger.inner_cyl1),
    ):
        for outer in (True, False):
            faces.append(_tiger_face(cyl, ocyl, icyl, ray_o, ray_d, outer, trig))
    inter = faces[0]
    for f in faces[1:]:
        inter = closest(f, inter)
    return inter


# --- Shared-projection fast paths (production fold only) ------------------
#
# The literal tiger/duocylinder intersections re-project the ray into
# each cylinder's axis 2-plane once PER FACE (8 faces x 2 ray_in_space +
# 16 dist_to_axes_plane point projections, shader.frag:317-341). But the
# tiger's four cylinders share just TWO axis pairs, projections are
# affine, and the clip distance at ray parameter t is the norm of
# po - d12*t in the projected plane — a quadratic in t with coefficients
# already computed for the family. Computing each family's projection
# once and folding faces in squared-distance space does the same math
# with ~2x fewer ops; equal to the literal path up to ulp re-association
# (mask edges may flip — bounded by tests/test_intersect_fast.py).


# Miss sentinel / squared threshold for the fast folds (models/scene.py
# defines the same values for its own fold).
_FAR = np.float32(1e30)
_SMALL2 = np.float32(float(SMALL_FLOAT) * float(SMALL_FLOAT))


class _CylFamily(NamedTuple):
    """Per-(point, axis1, axis2) projected-ray quantities.

    Everything radius-independent is computed ONCE here — including the
    unit-direction ``b``, the degenerate-origin mask and the squared
    perpendicular miss distance ``perp2`` that all of a family's circle
    tests share (the tiger runs 4 radius tests per family; only
    ``r^2`` differs between them)."""

    po: Vec4           # center - projected origin (in the 2-plane)
    d12: Vec4          # projected (non-unit) direction
    l2: jnp.ndarray    # |po|^2
    b_raw: jnp.ndarray     # dot(po, d12)
    len1_sq: jnp.ndarray   # |d - a1 dot(d,a1)|^2  (first projection)
    len12_sq: jnp.ndarray  # |d12|^2
    inv_len: jnp.ndarray   # 1/|d12| (guarded)
    proj_ok: jnp.ndarray   # both projection lengths >= SMALL_FLOAT
    b: jnp.ndarray         # unit-direction b (0 where degenerate)
    degenerate: jnp.ndarray  # |po|^2 < SMALL^2 (origin on the axis plane)
    perp2: jnp.ndarray     # l2 - b^2: squared perp distance of the circle
                           # center to the projected ray line


def _cyl_family(point: Vec4, axis1: Vec4, axis2: Vec4, ray_o: Vec4, ray_d: Vec4):
    co = point - ray_o
    a1c = dot(co, axis1)
    a2c = dot(co, axis2)
    po = co - axis1 * a1c - axis2 * a2c
    da1 = dot(ray_d, axis1)
    d1 = ray_d - axis1 * da1
    len1_sq = dot(d1, d1)
    da2 = dot(d1, axis2)
    d12 = d1 - axis2 * da2
    len12_sq = dot(d12, d12)
    proj_ok = jnp.logical_and(len1_sq >= _SMALL2, len12_sq >= _SMALL2)
    inv_len = jax.lax.rsqrt(jnp.where(proj_ok, len12_sq, 1.0))
    l2 = dot(po, po) + 1e-37
    b_raw = dot(po, d12)
    degenerate = l2 < _SMALL2
    b = jnp.where(degenerate, 0.0, b_raw * inv_len)
    return _CylFamily(
        po, d12, l2, b_raw,
        len1_sq, len12_sq, inv_len, proj_ok,
        b, degenerate, l2 - b * b,
    )


def _family_circle(fam: _CylFamily, r):
    """The radius-dependent remainder of a family's circle test, shared
    by the (r, outer=True) and (r, outer=False) faces: ONE
    disc/sqrt/receding evaluation per radius instead of per face.

    Returns (near, far, hit, use_near_outer): the two unscaled circle
    roots as ray parameters, the circle-hit mask, and the outer-face
    near-root select (l2 > r2). Identical values to _family_circle_dist
    (same op association: disc = r2 - (l2 - b*b) via fam.perp2)."""
    r2 = r * r
    receding = jnp.logical_and(
        jnp.logical_not(fam.degenerate),
        jnp.logical_and(fam.l2 >= r2, fam.b < 0.0),
    )
    disc = r2 - fam.perp2
    tangent = disc <= 0.0
    sq = jnp.sqrt(jnp.where(tangent, 1.0, disc))
    sq = jnp.where(tangent, 0.0, sq)
    near = (fam.b - sq) * fam.inv_len
    far = (fam.b + sq) * fam.inv_len
    hit = jnp.logical_and(
        fam.proj_ok, jnp.logical_not(jnp.logical_or(receding, tangent))
    )
    return near, far, hit, fam.l2 > r2


def _family_circle_dist(fam: _CylFamily, r, outer: bool):
    """(dist, hit, use_near) of the family's circle test at radius r —
    sphere_intersection's quadratic on the projected ray, with the
    1/|d12| unscaling folded in (shader.frag:260-266). Thin select over
    _family_circle's shared roots."""
    near, far, hit, use_near_outer = _family_circle(fam, r)
    use_near = use_near_outer if outer else (fam.l2 < -jnp.inf)
    return jnp.where(use_near, near, far), hit, use_near


def _family_clip_sq(fam: _CylFamily, t: jnp.ndarray) -> jnp.ndarray:
    """Squared distance to the family's axis 2-plane at ray parameter t:
    |po - d12*t|^2 = l2 - 2t*b_raw + t^2*|d12|^2 (dist_to_axes_plane,
    shader.frag:270-275, compared in squared space)."""
    return fam.l2 - 2.0 * t * fam.b_raw + t * t * fam.len12_sq


def _family_norm(fam: _CylFamily, dist, r, flip) -> Vec4:
    """Cylinder surface normal at parameter dist: (po - d12*dist)/r,
    negated where ``flip`` (the outer-hit-from-outside flip,
    shader.frag:218-219 via :260). ``flip=None`` = statically no flip
    (outer=False faces, where use_near is all-false). max(r, tiny):
    bitwise-identical for real radii; keeps a ZEROED family's (r=0,
    diff.zero_object) dead-branch values finite so cotangents stay 0
    instead of NaN."""
    inv_r = 1.0 / jnp.maximum(r, 1e-30)
    scale = inv_r if flip is None else jnp.where(flip, -inv_r, inv_r)
    return Vec4(
        (fam.po.x - fam.d12.x * dist) * scale,
        (fam.po.y - fam.d12.y * dist) * scale,
        (fam.po.z - fam.d12.z * dist) * scale,
        (fam.po.w - fam.d12.w * dist) * scale,
    )


def tiger_intersection_fast(tiger: TigerSpec, ray_o: Vec4, ray_d: Vec4) -> Intersection:
    """tiger_intersection with the two family projections shared across
    all 8 face tests and clips in squared space (see block comment)."""
    fam_a = _cyl_family(
        tiger.inner_cyl1.point, tiger.inner_cyl1.axis1, tiger.inner_cyl1.axis2,
        ray_o, ray_d,
    )
    fam_b = _cyl_family(
        tiger.inner_cyl2.point, tiger.inner_cyl2.axis1, tiger.inner_cyl2.axis2,
        ray_o, ray_d,
    )
    r_in_a, r_out_a = tiger.inner_cyl1.r, tiger.outer_cyl1.r
    r_in_b, r_out_b = tiger.inner_cyl2.r, tiger.outer_cyl2.r

    # Faces in the reference's order (shader.frag:328-335): family A's
    # cylinders clip against family B's annulus and vice versa.
    faces = []
    for fam, other, r_pairs, other_rs, mat in (
        (fam_a, fam_b, ((r_in_a, True), (r_in_a, False), (r_out_a, True), (r_out_a, False)),
         (r_in_b, r_out_b), tiger.inner_cyl1.material),
        (fam_b, fam_a, ((r_in_b, True), (r_in_b, False), (r_out_b, True), (r_out_b, False)),
         (r_in_a, r_out_a), tiger.inner_cyl2.material),
    ):
        o_in, o_out = other_rs
        for r, outer in r_pairs:
            dist, hit, use_near = _family_circle_dist(fam, r, outer)
            clip_sq = _family_clip_sq(other, dist)
            keep = jnp.logical_and(
                clip_sq <= o_out * o_out, clip_sq >= o_in * o_in
            )
            faces.append((jnp.logical_and(hit, keep), dist, fam, r, use_near, mat))

    # closest-fold over the 8 faces (dist + winner index), then resolve
    # the winner's normal/material once.
    FAR = _FAR
    best = jnp.where(faces[0][0], faces[0][1], FAR)
    idx = jnp.zeros_like(best, dtype=jnp.int32)
    for k, (hit, dist, *_rest) in enumerate(faces[1:], start=1):
        dk = jnp.where(hit, dist, FAR)
        take = dk < best
        best = jnp.where(take, dk, best)
        idx = jnp.where(take, jnp.int32(k), idx)

    any_hit = best < FAR * 0.5
    dist = jnp.where(any_hit, best, 0.0)
    zero = jnp.zeros_like(dist)
    norm = Vec4(zero, zero, zero, zero)
    glow, refl = zero, zero
    color = Vec3(zero, zero, zero)
    for k, (hit, _d, fam, r, use_near, mat) in enumerate(faces):
        mask = jnp.logical_and(any_hit, idx == k)
        nk = _family_norm(fam, dist, r, use_near)
        norm = nk.where(mask, norm)
        glow = jnp.where(mask, mat.glow, glow)
        refl = jnp.where(mask, mat.refl_prob, refl)
        color = Vec3(
            jnp.where(mask, mat.color.x, color.x),
            jnp.where(mask, mat.color.y, color.y),
            jnp.where(mask, mat.color.z, color.z),
        )
    return Intersection(any_hit, dist, norm, glow, refl, color)


def cylinders_union_intersection_fast(
    cyl1: CylinderSpec, cyl2: CylinderSpec, ray_o: Vec4, ray_d: Vec4
) -> Intersection:
    """cylinders_union_intersection with shared projections + squared
    clips — including the verbatim cylinder2.r clip on both arms
    (shader.frag:290, SURVEY C6i)."""
    fam1 = _cyl_family(cyl1.point, cyl1.axis1, cyl1.axis2, ray_o, ray_d)
    fam2 = _cyl_family(cyl2.point, cyl2.axis1, cyl2.axis2, ray_o, ray_d)
    r2sq = cyl2.r * cyl2.r

    d1, h1, near1 = _family_circle_dist(fam1, cyl1.r, True)
    h1 = jnp.logical_and(h1, _family_clip_sq(fam2, d1) <= r2sq)
    d2, h2, near2 = _family_circle_dist(fam2, cyl2.r, True)
    h2 = jnp.logical_and(h2, _family_clip_sq(fam1, d2) <= r2sq)

    take1 = jnp.logical_and(h1, jnp.logical_or(jnp.logical_not(h2), d1 < d2))
    hit = jnp.logical_or(h1, h2)
    dist = jnp.where(hit, jnp.where(take1, d1, d2), 0.0)
    n1 = _family_norm(fam1, dist, cyl1.r, near1)
    n2 = _family_norm(fam2, dist, cyl2.r, near2)
    norm = n1.where(take1, n2).where(hit, Vec4.zeros(dist))
    m1, m2 = cyl1.material, cyl2.material
    glow = jnp.where(hit, jnp.where(take1, m1.glow, m2.glow), 0.0)
    refl = jnp.where(hit, jnp.where(take1, m1.refl_prob, m2.refl_prob), 0.0)
    zero3 = Vec3(jnp.zeros_like(dist), jnp.zeros_like(dist), jnp.zeros_like(dist))
    color = m1.color.where(take1, m2.color)
    color = Vec3(
        jnp.broadcast_to(color.x, dist.shape),
        jnp.broadcast_to(color.y, dist.shape),
        jnp.broadcast_to(color.z, dist.shape),
    ).where(hit, zero3)
    return Intersection(hit, dist, norm, glow, refl, color)


# --- Cube & hypercube (shader.frag:344-400) ------------------------------

class CubeSpec(NamedTuple):
    """3D cube living in a hyperplane (shader.frag:345-350)."""

    space_point: Vec4
    space_norm: Vec4
    x: Vec4
    y: Vec4
    z: Vec4
    r: jnp.ndarray
    material: Material


def cube_intersection(cube: CubeSpec, ray_o: Vec4, ray_d: Vec4) -> Intersection:
    """Front-facing hyperplane hit + 3 axis-extent rejections
    (shader.frag:352-366). Returned normal is the cube's hyperplane
    normal, not flipped."""
    vec_n = -cube.space_norm
    vec_c = cube.space_point - ray_o
    h = dot(vec_c, vec_n)
    cos_dn = dot(ray_d, vec_n)
    facing = jnp.logical_and(h >= 0.0, cos_dn >= 0.0)
    dist = h / jnp.where(cos_dn == 0.0, 1e-30, cos_dn)
    p = ray_o + ray_d * dist
    vec_cp = p - cube.space_point
    inside = jnp.logical_and(
        jnp.abs(dot(vec_cp, cube.x)) <= cube.r,
        jnp.logical_and(
            jnp.abs(dot(vec_cp, cube.y)) <= cube.r,
            jnp.abs(dot(vec_cp, cube.z)) <= cube.r,
        ),
    )
    hit = jnp.logical_and(facing, inside)
    return _masked(hit, dist, cube.space_norm, cube.material, h)


class HypercubeSpec(NamedTuple):
    cubes: tuple  # 8 CubeSpec cells (the literal/spec representation)
    # Generator parameters (center + 4 axes + half-width), kept alongside
    # the cells for the shared-dot fast path (hypercube_intersection_fast):
    # all 8 cells' hyperplane/extent dots are +-combinations of the 8
    # dots (center-origin)*axis_i and direction*axis_i.
    point: Vec4 = None
    axes: tuple = None  # (x, y, z, w)
    r: jnp.ndarray = None


def make_hypercube(
    point: Vec4,
    x: Vec4,
    y: Vec4,
    z: Vec4,
    w: Vec4,
    r,
    materials: tuple,
) -> HypercubeSpec:
    """8 cells from center + 4 axes + half-width + 8 materials, in the
    reference's cell order (+x +y +z +w -x -y -z -w, shader.frag:374-392)."""
    r = jnp.asarray(r, jnp.float32)
    mxp, myp, mzp, mwp, mxn, myn, mzn, mwn = materials
    cells = (
        CubeSpec(point + x * r, x, y, z, w, r, mxp),
        CubeSpec(point + y * r, y, x, z, w, r, myp),
        CubeSpec(point + z * r, z, x, y, w, r, mzp),
        CubeSpec(point + w * r, w, x, y, z, r, mwp),
        CubeSpec(point - x * r, -x, y, z, w, r, mxn),
        CubeSpec(point - y * r, -y, x, z, w, r, myn),
        CubeSpec(point - z * r, -z, x, y, w, r, mzn),
        CubeSpec(point - w * r, -w, x, y, z, r, mwn),
    )
    return HypercubeSpec(cells, point, (x, y, z, w), r)


def hypercube_intersection(
    hypercube: HypercubeSpec, ray_o: Vec4, ray_d: Vec4
) -> Intersection:
    """First cell hit in declaration order (shader.frag:394-400 early-exit
    loop), not closest-distance — preserved exactly."""
    inter = cube_intersection(hypercube.cubes[0], ray_o, ray_d)
    for cell in hypercube.cubes[1:]:
        cand = cube_intersection(cell, ray_o, ray_d)
        take_cand = jnp.logical_and(jnp.logical_not(inter.hit), cand.hit)
        inter = cand.where(take_cand, inter)
    return inter


def hypercube_intersection_fast(
    hypercube: HypercubeSpec, ray_o: Vec4, ray_d: Vec4
) -> Intersection:
    """Shared-dot hypercube test: with center c, orthonormal axes a_i and
    half-width r, every cell's hyperplane offset, facing cosine and the
    three extent tests are +-combinations of co_i = dot(c - o, a_i) and
    dd_i = dot(d, a_i) — 8 dots total instead of 8 cells x 5 dots
    (cube_intersection). Cell order and first-hit-in-order semantics
    preserved (shader.frag:374-400); values match the literal path up to
    ulp re-association. Falls back to the literal path when the spec
    lacks generator params."""
    if hypercube.point is None or hypercube.axes is None:
        return hypercube_intersection(hypercube, ray_o, ray_d)
    c, axes, r = hypercube.point, hypercube.axes, hypercube.r
    co = [dot(c - ray_o, a) for a in axes]
    dd = [dot(ray_d, a) for a in axes]

    cells = []
    # +a_i cells then -a_i cells (make_hypercube's order).
    for sign in (1.0, -1.0):
        for i in range(4):
            # +cell: h = -(co_i + r), cos_dn = -dd_i;  -cell: h = co_i - r,
            # cos_dn = dd_i  (vec_n = -space_norm, cube_intersection).
            # ``sign`` is static: the branch resolves at trace time.
            h = -(co[i] + r) if sign > 0 else co[i] - r
            cos_dn = -dd[i] if sign > 0 else dd[i]
            facing = jnp.logical_and(h >= 0.0, cos_dn >= 0.0)
            dist = h / jnp.where(cos_dn == 0.0, 1e-30, cos_dn)
            inside = facing
            for j in range(4):
                if j == i:
                    continue
                e = dist * dd[j] - co[j]  # dot(hit - cell_center, a_j)
                inside = jnp.logical_and(inside, jnp.abs(e) <= r)
            mat = hypercube.cubes[(0 if sign > 0 else 4) + i].material
            cells.append((inside, dist, i, sign, mat))

    zero = jnp.zeros_like(ray_d.x)
    taken = zero > jnp.ones_like(zero)  # all-false as a computed compare
    dist = zero
    norm = Vec4(zero, zero, zero, zero)
    glow, refl = zero, zero
    color = Vec3(zero, zero, zero)
    for hit_k, dist_k, i, sign, mat in cells:
        take = jnp.logical_and(jnp.logical_not(taken), hit_k)
        taken = jnp.logical_or(taken, hit_k)
        dist = jnp.where(take, dist_k, dist)
        a = axes[i]
        norm = Vec4(
            jnp.where(take, sign * a.x, norm.x),
            jnp.where(take, sign * a.y, norm.y),
            jnp.where(take, sign * a.z, norm.z),
            jnp.where(take, sign * a.w, norm.w),
        )
        glow = jnp.where(take, mat.glow, glow)
        refl = jnp.where(take, mat.refl_prob, refl)
        color = Vec3(
            jnp.where(take, mat.color.x, color.x),
            jnp.where(take, mat.color.y, color.y),
            jnp.where(take, mat.color.z, color.z),
        )
    return Intersection(taken, dist, norm, glow, refl, color)
