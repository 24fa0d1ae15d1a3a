"""Scenes as differentiable parameter pytrees.

The reference resolves scenes at GLSL compile time by pasting a
``scenes/*.frag`` snippet into the shader (executable/README.md:9-11,
SURVEY §3.5). The equivalent here: a `Scene` pytree of traced
arrays — primitive counts are static (recompile per scene shape, like a
shader recompile), but every coordinate, radius, color, glow and mirror
probability is a JAX array, so the whole renderer differentiates w.r.t.
the scene.

`intersect_scene` is the analogue of each scene's ``find_intersection``
(e.g. shader.frag:434-451): a linear closest-fold over all primitives,
with the reference's fold order (spaces, spheres, cylinders, duocylinder,
hypercube, tiger). No acceleration structure, matching the reference
("all objects iterated without smart optimizations", shader.frag:433).
Primitive loops unroll at trace time — counts are tiny (<= 8) and the
per-primitive parameters broadcast as scalars against the ray batch,
which keeps the hot loop pure elementwise work.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from fourd_ray_tracing_tpu.ops import geometry as geo
from fourd_ray_tracing_tpu.ops.sampler import SMALL_FLOAT
from fourd_ray_tracing_tpu.ops.sky import Environment, Sun
from fourd_ray_tracing_tpu.ops.vec4 import Vec3, Vec4, dot


class SpaceSpec(NamedTuple):
    point: Vec4
    norm: Vec4
    material: geo.Material


class SphereSpec(NamedTuple):
    center: Vec4
    r: jnp.ndarray
    material: geo.Material


class Scene(NamedTuple):
    """A full scene: primitive tuples (static length) + environment."""

    spaces: Tuple[SpaceSpec, ...] = ()
    spheres: Tuple[SphereSpec, ...] = ()
    cylinders: Tuple[geo.CylinderSpec, ...] = ()
    cylinders_union: Optional[Tuple[geo.CylinderSpec, geo.CylinderSpec]] = None
    hypercube: Optional[geo.HypercubeSpec] = None
    tiger: Optional[geo.TigerSpec] = None
    environment: Optional[Environment] = None


# Miss sentinel for the fast fold: distances are scene-scale (~units),
# so any real hit is far below this. Masked out before the trace uses
# dist (0 on miss, like geo.miss_like), keeping forward values finite.
_FAR = np.float32(1e30)
_SMALL2 = np.float32(float(SMALL_FLOAT) * float(SMALL_FLOAT))


def plane_norm_hints(scene: Scene):
    """Static zero-component hints for hyperplane normals, or None.

    Every shipped scene's walls are axis-aligned (e.g. the room's 8
    hyperplanes, scenes/Комната со сферой.frag:6-15): 3 of the 4 normal
    components are exactly 0.0. The fast intersection fold can then skip
    those multiply-adds — the dominant per-bounce cost on closed scenes —
    without changing the forward value (x + 0*y == x in float32 for
    finite x).

    Only derivable OUTSIDE jit: returns None when any normal component is
    a tracer. The returned value is a hashable tuple-of-tuples of bools
    (True = component is exactly 0.0), suitable as a static jit argument
    (threaded via RenderConfig.plane_hints). Production-forward only:
    gradients w.r.t. hinted-zero normal components vanish under hints, so
    the autodiff/oracle jnp path never auto-applies them.
    """
    import jax.core as jcore

    hints = []
    for sp in scene.spaces:
        comps = (sp.norm.x, sp.norm.y, sp.norm.z, sp.norm.w)
        if any(isinstance(c, jcore.Tracer) for c in comps):
            return None
        hints.append(tuple(bool(np.asarray(c) == 0.0) for c in comps))
    return tuple(hints) if hints else None


def plane_pair_hints(scene: Scene, hints):
    """Static opposite-wall pairs for the fast fold, or None.

    Closed-box scenes (the room, scenes/Комната со сферой.frag:6-15) put
    TWO hyperplanes on each coordinate axis; for a given ray at most one
    wall of such a pair is the nearer candidate, so the fold can test the
    pair with ONE division and one fold step instead of two
    (intersect_scene_fast). Pairing requires concrete geometry and
    unit single-axis normals (|n_k| == 1, the shipped-scene case — the
    per-plane SMALL_FLOAT hit threshold then carries over exactly).

    Returns (pairs, singles): pairs = tuple of (i, j, axis) with
    offset_i < offset_j along ``axis`` (the static ordering the kernel's
    2-select nearest-wall formula relies on); singles = indices of
    unpaired planes. None when pairing is unavailable/pointless.
    """
    import jax.core as jcore

    if hints is None or len(scene.spaces) < 2:
        return None
    by_axis = {}
    for i, (sp, hint) in enumerate(zip(scene.spaces, hints)):
        if hint.count(True) != 3:
            continue
        axis = hint.index(False)
        comps = (sp.norm.x, sp.norm.y, sp.norm.z, sp.norm.w)
        pts = (sp.point.x, sp.point.y, sp.point.z, sp.point.w)
        if any(isinstance(c, jcore.Tracer) for c in comps + pts):
            return None
        nk = float(np.asarray(comps[axis]))
        if abs(nk) != 1.0:
            continue
        # effective axis offset: plane is {x_axis == c}
        c = float(sum(np.asarray(p) * np.asarray(n) for p, n in zip(pts, comps))) / nk
        by_axis.setdefault(axis, []).append((c, i))
    pairs = []
    paired = set()
    for axis, entries in by_axis.items():
        entries.sort()
        while len(entries) >= 2:
            (ca, i), (cb, j) = entries[0], entries[1]
            entries = entries[2:]
            if ca == cb:
                continue  # coincident planes: keep literal semantics
            pairs.append((i, j, axis))
            paired.update((i, j))
    if not pairs:
        return None
    singles = tuple(i for i in range(len(scene.spaces)) if i not in paired)
    return tuple(pairs), singles


class AxisHints(NamedTuple):
    """Static axis-alignment hints for the fast fold (axis_alignment_hints).

    Every shipped composite scene builds its cylinders/hypercube from
    EXACT unit basis vectors (scenes/*.frag), so the per-bounce
    projection dots (dot(co, axis), ray_in_space subtractions,
    shader.frag:252-258) collapse to component picks with the zero terms
    statically dropped — the same forward-identical term-dropping as
    plane_norm_hints, extended to the cylinder families and hypercube.
    Each axis entry is (component_index, sign) or None (not aligned).

    Production-forward only (dropped terms would carry zero gradients);
    derived by the kernel entry points / engine from the concrete scene
    and threaded as a static jit argument via RenderConfig.axis_hints.
    """

    cylinders: tuple = ()        # per cylinder: ((k1,s1),(k2,s2)) or None
    cylinders_union: tuple | None = None  # (fam1_axes, fam2_axes) or None
    hypercube: tuple | None = None        # ((k,s),)*4 or None
    tiger: tuple | None = None            # (famA_axes, famB_axes) or None


def _unit_axis_of(v: Vec4):
    """(component_index, sign) when v is EXACTLY a signed unit basis
    vector (concrete values only), else None."""
    import jax.core as jcore

    comps = (v.x, v.y, v.z, v.w)
    if any(isinstance(c, jcore.Tracer) for c in comps):
        return None
    vals = [float(np.asarray(c)) for c in comps]
    nonzero = [(k, s) for k, s in enumerate(vals) if s != 0.0]
    if len(nonzero) != 1 or abs(nonzero[0][1]) != 1.0:
        return None
    return (nonzero[0][0], nonzero[0][1])


def _axis_pair(a1: Vec4, a2: Vec4):
    h1, h2 = _unit_axis_of(a1), _unit_axis_of(a2)
    if h1 is None or h2 is None or h1[0] == h2[0]:
        return None
    return (h1, h2)


def axis_alignment_hints(scene: Scene):
    """AxisHints for the scene's composite primitives, or None when
    nothing is axis-aligned / values are traced (see AxisHints)."""
    cyl_hints = tuple(
        _axis_pair(c.axis1, c.axis2) for c in scene.cylinders
    )
    union_hints = None
    if scene.cylinders_union is not None:
        c1, c2 = scene.cylinders_union
        p1, p2 = _axis_pair(c1.axis1, c1.axis2), _axis_pair(c2.axis1, c2.axis2)
        if p1 is not None and p2 is not None:
            union_hints = (p1, p2)
    hc_hints = None
    if scene.hypercube is not None and scene.hypercube.axes is not None:
        hs = tuple(_unit_axis_of(a) for a in scene.hypercube.axes)
        if all(h is not None for h in hs):
            hc_hints = hs
    tiger_hints = None
    if scene.tiger is not None:
        tg = scene.tiger
        pa = _axis_pair(tg.inner_cyl1.axis1, tg.inner_cyl1.axis2)
        pb = _axis_pair(tg.inner_cyl2.axis1, tg.inner_cyl2.axis2)
        if pa is not None and pb is not None:
            tiger_hints = (pa, pb)
    hints = AxisHints(cyl_hints, union_hints, hc_hints, tiger_hints)
    if (all(h is None for h in cyl_hints) and union_hints is None
            and hc_hints is None and tiger_hints is None):
        return None
    return hints


def _cyl_family_aligned(point: Vec4, pair, ray_o: Vec4, ray_d: Vec4):
    """geo._cyl_family for a family whose two axes are signed unit basis
    vectors ((k1,s1),(k2,s2)): the projections become component zeroing,
    the dots sum only the two live components (bit-identical — the
    dropped terms are exact float zeros in the full dots)."""
    (k1, _s1), (k2, _s2) = pair
    live = [j for j in range(4) if j not in (k1, k2)]
    zero = jnp.zeros_like(ray_d.x)
    co = [pc - oc for pc, oc in zip(point, ray_o)]
    po_c = [zero if j in (k1, k2) else co[j] for j in range(4)]
    d_c = list(ray_d)
    d12_c = [zero if j in (k1, k2) else d_c[j] for j in range(4)]
    a, b = live
    l2 = co[a] * co[a] + co[b] * co[b] + 1e-37
    b_raw = co[a] * d_c[a] + co[b] * d_c[b]
    # len1_sq drops only k1 (first projection, shader.frag:252-254).
    l1_live = [j for j in range(4) if j != k1]
    len1_sq = sum(
        (d_c[j] * d_c[j] for j in l1_live[1:]),
        d_c[l1_live[0]] * d_c[l1_live[0]],
    )
    len12_sq = d_c[a] * d_c[a] + d_c[b] * d_c[b]
    proj_ok = jnp.logical_and(len1_sq >= _SMALL2, len12_sq >= _SMALL2)
    import jax as _jax

    inv_len = _jax.lax.rsqrt(jnp.where(proj_ok, len12_sq, 1.0))
    degenerate = l2 < _SMALL2
    b_unit = jnp.where(degenerate, 0.0, b_raw * inv_len)
    return geo._CylFamily(
        Vec4(*po_c), Vec4(*d12_c), l2, b_raw,
        len1_sq, len12_sq, inv_len, proj_ok,
        b_unit, degenerate, l2 - b_unit * b_unit,
    )


def _make_family(point, axis1, axis2, pair, o, d):
    if pair is None:
        return geo._cyl_family(point, axis1, axis2, o, d)
    return _cyl_family_aligned(point, pair, o, d)


def intersect_scene_fast(
    scene: Scene, ray_o: Vec4, ray_d: Vec4, plane_hints=None, plane_pairs=None,
    axis_hints=None,
) -> geo.Intersection:
    """Fused closest-hit with identical semantics to `intersect_scene_spec`
    but restructured for vector lanes (the production path of trace_rays):

    * fold only a masked DISTANCE per candidate (miss -> _FAR) plus a
      winner index — 3 ops per candidate instead of selecting all 11
      Intersection fields per fold;
    * resolve the winner's normal and material ONCE after the fold
      (hyperplane normals are +-norm_k, sphere normals recompute from
      the single folded hit point);
    * hyperplanes use the signed-division identity
      |dot_vn| / (sign(dot_vn)*dot_dn) == dot_vn / dot_dn, skipping the
      premultiplied normal and abs;
    * spheres run entirely in squared-length space (l^2 vs r^2), never
      materializing |center - origin| — one sqrt total (discriminant).

    Mask-edge behavior (grazing hits, degenerate origins) can differ
    from the spec path at ulp level (l^2+eps vs sqrt(l^2+eps) rounding);
    tests/test_geometry.py bounds the disagreement to boundary pixels.
    """
    o, d = ray_o, ray_d
    zero = jnp.zeros_like(d.x)

    dists = []      # masked distance per candidate, _FAR on miss
    # Per-candidate field producers: resolve(dist, hit_p) -> (norm: Vec4,
    # glow, refl, color: Vec3), computed UNCONDITIONALLY (scalars allowed
    # — they broadcast through the selects); the winner's fields are
    # picked by a balanced select tree over the winner index in
    # _resolve_fold (depth ceil(log2 N) instead of an N-deep masked
    # chain — the resolver chain sits on the bounce critical path
    # between the fold and the direction update).
    resolvers = []

    if plane_hints is not None:
        if len(plane_hints) != len(scene.spaces):
            raise ValueError(
                f"plane_hints has {len(plane_hints)} entries for "
                f"{len(scene.spaces)} hyperplanes"
            )
        # A True hint for a nonzero normal component would silently drop
        # that dot-product term and render a wrong image; when the normal
        # components are concrete (non-Tracer), verify each hinted
        # component is exactly 0.0.
        import jax.core as jcore

        for k_sp, (sp, hint) in enumerate(zip(scene.spaces, plane_hints)):
            for comp_name, c, z in zip(
                "xyzw", (sp.norm.x, sp.norm.y, sp.norm.z, sp.norm.w), hint
            ):
                if z and not isinstance(c, jcore.Tracer) and np.asarray(c) != 0.0:
                    raise ValueError(
                        f"plane_hints[{k_sp}].{comp_name} claims a zero normal "
                        f"component but its value is {np.asarray(c)!r}; hints "
                        "must come from plane_norm_hints"
                    )
    def add_single_plane(k_sp, sp):
        n = sp.norm
        # True = that normal component is statically exactly 0.0, so its
        # multiply-adds drop out of the per-lane dots (see plane_norm_hints).
        hint = plane_hints[k_sp] if plane_hints is not None else (False,) * 4
        cn = dot(sp.point, n)  # scalar (per-scene, hoisted out of the lanes)
        live = [
            (oc, dc, nc)
            for oc, dc, nc, z in zip(o, d, n, hint)
            if not z
        ] or [(o.x, d.x, n.x)]
        on = sum((oc * nc for oc, dc, nc in live[1:]), live[0][0] * live[0][2])
        dn = sum((dc * nc for oc, dc, nc in live[1:]), live[0][1] * live[0][2])
        dot_vn = cn - on
        sgn = jnp.sign(dot_vn)
        hit = sgn * dn >= SMALL_FLOAT
        dist = dot_vn / jnp.where(hit, dn, 1.0)
        dists.append(jnp.where(hit, dist, _FAR))

        def resolve(dist, hit_p, n=n, sgn=sgn, hint=hint, mat=sp.material):
            flip = -sgn
            comps = [
                zero if z else flip * nc
                for nc, z in zip(n, hint)
            ]
            return Vec4(*comps), mat.glow, mat.refl_prob, mat.color

        resolvers.append(resolve)

    def add_plane_pair(i, j, axis):
        """Opposite walls on one axis as ONE candidate (plane_pair_hints):
        for any ray at most one wall of the pair can be the nearer hit, so
        select the nearest wall in the travel direction with two compares
        and pay a single division + fold step. Requires |n_axis| == 1 and
        offset_i < offset_j (both guaranteed statically by the hint
        derivation), which makes the per-plane SMALL_FLOAT threshold and
        distances bit-identical to the two single-plane candidates."""
        sp_a, sp_b = scene.spaces[i], scene.spaces[j]
        na = sp_a.norm[axis]  # +-1.0 (scalar)
        nb = sp_b.norm[axis]
        ca = dot(sp_a.point, sp_a.norm) / na  # scalar axis offset, hoisted
        cb = dot(sp_b.point, sp_b.norm) / nb
        o_k = o[axis]
        d_k = d[axis]
        going_up = d_k > 0.0
        up_a = o_k < ca      # below both walls -> nearest going up is a
        down_b = o_k > cb    # above both walls -> nearest going down is b
        take_a = (going_up & up_a) | (~going_up & ~down_b)
        p_near = jnp.where(take_a, ca, cb)
        dot_vn = p_near - o_k
        sgn = jnp.sign(dot_vn)
        hit = sgn * d_k >= SMALL_FLOAT
        dist = dot_vn / jnp.where(hit, d_k, 1.0)
        dists.append(jnp.where(hit, dist, _FAR))

        def resolve(dist, hit_p, sgn=sgn, take_a=take_a, axis=axis,
                    mat_a=sp_a.material, mat_b=sp_b.material):
            comps = [zero, zero, zero, zero]
            # The ray-facing normal of a double-sided axis plane is
            # -sign(offset - o_k) * e_axis regardless of the stored
            # normal's sign (it cancels: -sign(n_k*s)*n_k = -s for
            # |n_k| = 1), so no select over (na, nb) is needed.
            comps[axis] = -sgn
            glow = jnp.where(take_a, mat_a.glow, mat_b.glow)
            refl = jnp.where(take_a, mat_a.refl_prob, mat_b.refl_prob)
            color = Vec3(
                jnp.where(take_a, mat_a.color.x, mat_b.color.x),
                jnp.where(take_a, mat_a.color.y, mat_b.color.y),
                jnp.where(take_a, mat_a.color.z, mat_b.color.z),
            )
            return Vec4(*comps), glow, refl, color

        resolvers.append(resolve)

    if plane_pairs is not None and plane_hints is not None:
        pairs, singles = plane_pairs
        for i, j, axis in pairs:
            add_plane_pair(i, j, axis)
        for i in singles:
            add_single_plane(i, scene.spaces[i])
    else:
        for k_sp, sp in enumerate(scene.spaces):
            add_single_plane(k_sp, sp)

    for s in scene.spheres:
        c, r = s.center, s.r
        r2 = r * r  # scalar
        po = c - o
        b = dot(po, d)
        l2 = dot(po, po) + 1e-37  # the spec's safe-length floor, squared
        degenerate = l2 < _SMALL2
        b = jnp.where(degenerate, 0.0, b)
        receding = jnp.logical_and(
            jnp.logical_not(degenerate), jnp.logical_and(l2 >= r2, b < 0.0)
        )
        disc = r2 - (l2 - b * b)
        tangent = disc <= 0.0
        sq = jnp.sqrt(jnp.where(tangent, 1.0, disc))
        sq = jnp.where(tangent, 0.0, sq)
        use_near = l2 > r2
        dist = jnp.where(use_near, b - sq, b + sq)
        hit = jnp.logical_not(jnp.logical_or(receding, tangent))
        dists.append(jnp.where(hit, dist, _FAR))

        def resolve(dist, hit_p, c=c, r=r, use_near=use_near, mat=s.material):
            # max(r, tiny): bitwise-identical for any real radius, and a
            # ZEROED sphere (diff.zero_object, r=0 -> guaranteed miss)
            # keeps finite dead-branch values so its cotangents stay an
            # exact 0 instead of 0*inf = NaN.
            inv_r = 1.0 / jnp.maximum(r, 1e-30)  # scalar
            scale = jnp.where(use_near, -inv_r, inv_r)
            nrm = Vec4(
                (c.x - hit_p.x) * scale,
                (c.y - hit_p.y) * scale,
                (c.z - hit_p.z) * scale,
                (c.w - hit_p.w) * scale,
            )
            return nrm, mat.glow, mat.refl_prob, mat.color

        resolvers.append(resolve)

    def composite(rec: geo.Intersection):
        dists.append(jnp.where(rec.hit, rec.dist, _FAR))

        def resolve(dist, hit_p, rec=rec):
            return rec.norm, rec.glow, rec.refl_prob, rec.color

        resolvers.append(resolve)

    # Cylinder-family primitives fold their faces DIRECTLY into the
    # global dist-fold (one masked distance each) and defer the family
    # normal/material to the single winner resolve — no intermediate
    # Intersection record, no double winner-resolution.
    def add_family_face(fam, dist_c, hit_c, flip, r, mat):
        dists.append(jnp.where(hit_c, dist_c, _FAR))

        def resolve(dist, hit_p, fam=fam, r=r, flip=flip, m=mat):
            nrm = geo._family_norm(fam, dist, r, flip)
            return nrm, m.glow, m.refl_prob, m.color

        resolvers.append(resolve)

    ah = axis_hints if axis_hints is not None else AxisHints()

    for k_cyl, cyl in enumerate(scene.cylinders):
        pair = ah.cylinders[k_cyl] if k_cyl < len(ah.cylinders) else None
        fam = _make_family(cyl.point, cyl.axis1, cyl.axis2, pair, o, d)
        dist_c, hit_c, use_near = geo._family_circle_dist(fam, cyl.r, True)
        add_family_face(fam, dist_c, hit_c, use_near, cyl.r, cyl.material)

    if scene.cylinders_union is not None:
        # Duocylinder: two faces, each clipped against the OTHER family's
        # radius — verbatim cyl2.r on both arms (shader.frag:290, C6i).
        c1, c2 = scene.cylinders_union
        u1, u2 = ah.cylinders_union or (None, None)
        fam1 = _make_family(c1.point, c1.axis1, c1.axis2, u1, o, d)
        fam2 = _make_family(c2.point, c2.axis1, c2.axis2, u2, o, d)
        r2sq = c2.r * c2.r
        for fam, other, r, mat in (
            (fam1, fam2, c1.r, c1.material),
            (fam2, fam1, c2.r, c2.material),
        ):
            dist_c, hit_c, use_near = geo._family_circle_dist(fam, r, True)
            hit_c = jnp.logical_and(
                hit_c, geo._family_clip_sq(other, dist_c) <= r2sq
            )
            add_family_face(fam, dist_c, hit_c, use_near, r, mat)

    if scene.hypercube is not None:
        hc = scene.hypercube
        if hc.point is None or hc.axes is None:
            composite(geo.hypercube_intersection(hc, o, d))
        else:
            # Shared-dot cells (geo.hypercube_intersection_fast) as
            # direct fold candidates. The hypercube boundary is convex
            # and cells only register ENTRY hits (facing test), so at
            # most one cell hits per ray and the reference's
            # first-hit-in-order semantics (shader.frag:394-400)
            # coincide with the closest fold; shared-edge ties keep the
            # earlier cell, like the reference's early-exit loop.
            #
            # Opposite-cell pairing (the cell analogue of the wall-pair
            # fold): per axis i the +cell faces the ray iff dd_i <= 0
            # (its cos_dn = -dd_i) and the -cell iff dd_i >= 0 — at most
            # one of the pair can pass the facing gate, so each axis
            # folds ONE candidate with sign-selected h/material instead
            # of two: 4 fold candidates, 4 resolvers. Values equal the
            # per-cell path on the selected (only possibly-hitting) cell.
            c, axes, r = hc.point, hc.axes, hc.r
            if ah.hypercube is not None:
                # Axis-aligned cells: dot(c - o, ±e_k) = ±(c_k - o_k).
                co = [s * (c[k] - o[k]) for k, s in ah.hypercube]
                dd = [s * d[k] for k, s in ah.hypercube]
            else:
                co = [dot(c - o, a) for a in axes]
                dd = [dot(d, a) for a in axes]
            for i in range(4):
                pos = dd[i] <= 0.0  # +cell is the facing one
                h = jnp.where(pos, -(co[i] + r), co[i] - r)
                cos_dn = jnp.abs(dd[i])
                facing = h >= 0.0  # cos_dn >= 0 holds by construction
                dist_c = h / jnp.where(cos_dn == 0.0, 1e-30, cos_dn)
                inside = facing
                for j in range(4):
                    if j == i:
                        continue
                    e = dist_c * dd[j] - co[j]
                    inside = jnp.logical_and(inside, jnp.abs(e) <= r)
                dists.append(jnp.where(inside, dist_c, _FAR))

                def resolve(dist, hit_p, a=axes[i], pos=pos,
                            mat_p=hc.cubes[i].material,
                            mat_n=hc.cubes[4 + i].material):
                    sgn = jnp.where(pos, 1.0, -1.0)
                    nrm = Vec4(sgn * a.x, sgn * a.y, sgn * a.z, sgn * a.w)
                    glow = jnp.where(pos, mat_p.glow, mat_n.glow)
                    refl = jnp.where(pos, mat_p.refl_prob, mat_n.refl_prob)
                    color = Vec3(
                        jnp.where(pos, mat_p.color.x, mat_n.color.x),
                        jnp.where(pos, mat_p.color.y, mat_n.color.y),
                        jnp.where(pos, mat_p.color.z, mat_n.color.z),
                    )
                    return nrm, glow, refl, color

                resolvers.append(resolve)

    if scene.tiger is not None:
        # 4 merged tiger candidates: the two family
        # projections and the per-radius circle tests are shared as
        # before (geo._family_circle), and additionally each (family,
        # radius)'s outer∈{T,F} face PAIR folds as ONE candidate. Why
        # this is bitwise-exact vs the 8-face fold (shader.frag:328-335):
        #   * origin outside the circle (use_near_outer): the outer face
        #     sits at the near root, the inner at the far root, and
        #     near < far strictly whenever the circle hits (tangency is
        #     masked out) — so if the near face passes the annulus clip
        #     it beats the far face in ANY fold; otherwise the pair's
        #     only live candidate is the far face (flip=False).
        #   * origin inside the circle: both faces sit at the far root
        #     with identical clip and flip=False — literal duplicates
        #     the old fold carried twice.
        # The merged record (dist, hit, flip) therefore equals the old
        # pair's fold winner lane-for-lane, at half the fold/resolver
        # candidates; both clip evaluations (near and far) remain, same
        # as before. Candidate order (A:r_in, A:r_out, B:r_in, B:r_out)
        # preserves the reference's tie order between pairs.
        tg = scene.tiger
        ta, tb = ah.tiger or (None, None)
        fam_a = _make_family(
            tg.inner_cyl1.point, tg.inner_cyl1.axis1, tg.inner_cyl1.axis2,
            ta, o, d,
        )
        fam_b = _make_family(
            tg.inner_cyl2.point, tg.inner_cyl2.axis1, tg.inner_cyl2.axis2,
            tb, o, d,
        )
        for fam, other, r_in, r_out, o_in, o_out, mat in (
            (fam_a, fam_b, tg.inner_cyl1.r, tg.outer_cyl1.r,
             tg.inner_cyl2.r, tg.outer_cyl2.r, tg.inner_cyl1.material),
            (fam_b, fam_a, tg.inner_cyl2.r, tg.outer_cyl2.r,
             tg.inner_cyl1.r, tg.outer_cyl1.r, tg.inner_cyl2.material),
        ):
            o_in2, o_out2 = o_in * o_in, o_out * o_out
            for r in (r_in, r_out):
                near, far, hit_c, use_near_outer = geo._family_circle(fam, r)
                clip_near = geo._family_clip_sq(other, near)
                clip_far = geo._family_clip_sq(other, far)
                keep_near = jnp.logical_and(
                    clip_near <= o_out2, clip_near >= o_in2
                )
                keep_far = jnp.logical_and(
                    clip_far <= o_out2, clip_far >= o_in2
                )
                take_near = jnp.logical_and(use_near_outer, keep_near)
                dist_c = jnp.where(take_near, near, far)
                keep = jnp.logical_or(take_near, keep_far)
                add_family_face(
                    fam, dist_c, jnp.logical_and(hit_c, keep), take_near,
                    r, mat,
                )

    if not dists:
        return geo.miss_like(d.x)

    # Fold: strictly-nearer wins, ties keep the earlier candidate —
    # exactly `closest(new, acc)` (shader.frag:181-185 via scene fold
    # order). Structured as a TREE reduction, not a serial scan: the
    # winner is the lexicographic (dist, index) minimum, which is
    # associative, so pairwise merging in index order is BITWISE equal
    # to the serial fold while shortening the lane-serial dependency
    # chain from N-1 to ceil(log2 N) compare+select rounds.
    if not _FOLD_TREE:  # A/B switch; serial reference
        best = dists[0]
        idx = jnp.zeros_like(zero, dtype=jnp.int32)
        for k, dk in enumerate(dists[1:], start=1):
            take = dk < best
            best = jnp.where(take, dk, best)
            idx = jnp.where(take, jnp.int32(k), idx)
        return _resolve_fold(o, d, zero, dists, resolvers, best, idx)
    nodes = [
        (dk, jnp.full_like(zero, k, dtype=jnp.int32))
        for k, dk in enumerate(dists)
    ]
    while len(nodes) > 1:
        merged = []
        for a in range(0, len(nodes) - 1, 2):
            (da, ia), (db, ib) = nodes[a], nodes[a + 1]
            take_b = db < da  # ties keep the earlier (left) candidate
            merged.append(
                (jnp.where(take_b, db, da), jnp.where(take_b, ib, ia))
            )
        if len(nodes) % 2:
            merged.append(nodes[-1])
        nodes = merged
    best, idx = nodes[0]
    return _resolve_fold(o, d, zero, dists, resolvers, best, idx)


# A/B switches for the dist fold and the winner resolver, both
# bit-identical in value; which is faster on the GPU is not measured yet
# (ROADMAP D3). The resolver tree keeps every candidate's field set live
# until its root, trading register pressure for select depth; the dist
# fold's per-candidate state is one array.
_FOLD_TREE = True
_RESOLVE_TREE = False


def _resolve_fold(o, d, zero, dists, resolvers, best, idx):
    hit = best < _FAR * 0.5
    dist = jnp.where(hit, best, 0.0)
    hit_p = o + d * dist  # shared by every sphere resolver

    outs = [r(dist, hit_p) for r in resolvers]

    if not _RESOLVE_TREE:  # A/B switch: the serial masked chain
        norm = Vec4(zero, zero, zero, zero)
        glow, refl = zero, zero
        color = Vec3(zero, zero, zero)
        for k, (nk, gk, rk, ck) in enumerate(outs):
            mask = jnp.logical_and(hit, idx == k)
            norm = nk.where(mask, norm)
            glow = jnp.where(mask, gk, glow)
            refl = jnp.where(mask, rk, refl)
            color = ck.where(mask, color)
        return geo.Intersection(hit, dist, norm, glow, refl, color)

    # Balanced select tree over the winner index: equals "the fields of
    # resolver[idx]" exactly (the masks of the old serial chain were
    # disjoint), at depth ceil(log2 N) instead of N selects on the
    # bounce-critical path. Scalar fields (plane/face materials)
    # broadcast lazily through the selects.
    def pick(lo, hi):
        if hi - lo == 1:
            return outs[lo]
        mid = (lo + hi) // 2
        left = pick(lo, mid)
        right_out = pick(mid, hi)
        right = idx >= mid
        return (
            right_out[0].where(right, left[0]),
            jnp.where(right, right_out[1], left[1]),
            jnp.where(right, right_out[2], left[2]),
            right_out[3].where(right, left[3]),
        )

    norm, glow, refl, color = pick(0, len(resolvers))
    # Miss lanes keep all-zero fields, exactly like the old chain's
    # untouched initial accumulators.
    zero3 = Vec3(zero, zero, zero)
    zero4 = Vec4(zero, zero, zero, zero)
    norm = norm.where(hit, zero4)
    glow = jnp.where(hit, glow, 0.0)
    refl = jnp.where(hit, refl, 0.0)
    color = color.where(hit, zero3)
    return geo.Intersection(hit, dist, norm, glow, refl, color)


def intersect_scene_spec(
    scene: Scene, ray_o: Vec4, ray_d: Vec4, trig: bool = False
) -> geo.Intersection:
    """Closest hit over every primitive (find_intersection analogue).

    ``trig`` selects the reference's literal trigonometric sphere/circle
    solution everywhere (shader.frag:197-221, also inside cylinders) —
    the configuration tested against the independent oracle
    (oracle/frag.py, tests/test_oracle.py)."""
    sphere_fn = geo.sphere_intersection_trig if trig else geo.sphere_intersection
    inter = geo.miss_like(ray_o.x)
    for sp in scene.spaces:
        inter = geo.closest(
            geo.space_intersection(sp.point, sp.norm, sp.material, ray_o, ray_d),
            inter,
        )
    for s in scene.spheres:
        inter = geo.closest(
            sphere_fn(s.center, s.r, s.material, ray_o, ray_d, True),
            inter,
        )
    for c in scene.cylinders:
        inter = geo.closest(
            geo.cylinder_intersection(
                c.point, c.axis1, c.axis2, c.r, c.material, ray_o, ray_d, True, trig
            ),
            inter,
        )
    if scene.cylinders_union is not None:
        c1, c2 = scene.cylinders_union
        inter = geo.closest(
            geo.cylinders_union_intersection(c1, c2, ray_o, ray_d, trig), inter
        )
    if scene.hypercube is not None:
        inter = geo.closest(
            geo.hypercube_intersection(scene.hypercube, ray_o, ray_d), inter
        )
    if scene.tiger is not None:
        inter = geo.closest(
            geo.tiger_intersection(scene.tiger, ray_o, ray_d, trig), inter
        )
    return inter


def intersect_scene(
    scene: Scene, ray_o: Vec4, ray_d: Vec4, mode: str = "fast",
    plane_hints=None, plane_pairs=None, axis_hints=None,
) -> geo.Intersection:
    """Dispatch: "fast" (production, fused fold), "spec" (literal
    per-primitive fold, the executable spec the fast path is tested
    against) or "trig" (spec with the reference's literal trigonometric
    sphere solution — the oracle-parity configuration). ``plane_hints`` /
    ``plane_pairs`` / ``axis_hints`` (fast mode only): static hints from
    `plane_norm_hints` / `plane_pair_hints` / `axis_alignment_hints`."""
    if mode == "spec":
        return intersect_scene_spec(scene, ray_o, ray_d)
    if mode == "trig":
        return intersect_scene_spec(scene, ray_o, ray_d, trig=True)
    return intersect_scene_fast(
        scene, ray_o, ray_d, plane_hints=plane_hints, plane_pairs=plane_pairs,
        axis_hints=axis_hints,
    )


# --- Convenience constructors (Python-float friendly) --------------------

def material(glow: float, refl_prob: float, color: tuple) -> geo.Material:
    return geo.Material.of(glow, refl_prob, color)


def space(point: tuple, norm: tuple, mat: geo.Material) -> SpaceSpec:
    return SpaceSpec(Vec4.of(*point), Vec4.of(*norm), mat)


def sphere(center: tuple, r: float, mat: geo.Material) -> SphereSpec:
    return SphereSpec(Vec4.of(*center), jnp.asarray(r, jnp.float32), mat)


def cylinder(point: tuple, axis1: tuple, axis2: tuple, r: float, mat: geo.Material):
    return geo.CylinderSpec(
        Vec4.of(*point), Vec4.of(*axis1), Vec4.of(*axis2),
        jnp.asarray(r, jnp.float32), mat,
    )


def sun(drct: tuple, angular_size: float, light: tuple, sharpness: float) -> Sun:
    return Sun(
        Vec4.of(*drct),
        jnp.asarray(angular_size, jnp.float32),
        Vec3.of(*light),
        jnp.asarray(sharpness, jnp.float32),
    )


def environment(sun_: Sun, sky_light: tuple, enabled: bool = True) -> Environment:
    return Environment(sun_, Vec3.of(*sky_light), enabled)
