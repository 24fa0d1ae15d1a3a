"""Differentiable rendering: losses, gradients, inverse-rendering steps.

The reference has no gradient path; BASELINE.json's north star adds one:
the forward renderer differentiates w.r.t. every scene parameter
(positions, radii, colors, glow, mirror probabilities) via
reparameterized Monte Carlo gradients.

Estimator decisions (documented per SURVEY §7 "hard parts"):

* **Fixed-outcome reparameterization.** All randomness is counter-based
  and parameter-independent, so for a fixed seed the sampled uniforms are
  constants; gradients flow through the *continuous* geometry (hit
  distances, normals, shading) while discrete decisions (hit/miss,
  mirror/diffuse) are frozen at their sampled outcomes. This is exactly
  "differentiate the estimator at fixed RNG", matching what the oracle
  computes with finite differences at the same seed.
* Consequences: d/d(refl_prob) of the branch *choice* is zero a.e. (the
  glow/albedo terms still carry refl_prob-independent gradients), and
  visibility edges contribute no boundary terms under the plain
  estimator. Geometry parameters whose only effect is a silhouette
  (e.g. a flat emissive sphere's position) therefore get ZERO gradient
  from `image_loss` — that is the correct derivative of the fixed-seed
  estimator, not a bug (tests/test_grad.py:
  test_geometry_grads_are_boundary_blind).
* **Soft-silhouette boundary gradients** (`soft_image_loss`): to move
  geometry through its silhouette, the loss renders the scene twice —
  with and without one designated sphere — and alpha-blends the two
  images with a differentiable primary-ray coverage
  alpha = sigmoid((r - d_perp)/edge_width), where d_perp is the
  perpendicular distance from the sphere center to each pixel's primary
  ray. The blend equals the hard render away from the edge band and
  gives the classic soft-rasterizer position/radius gradients inside it.
  Secondary effects (shadows, reflections of the sphere) stay hard —
  acceptable for silhouette-driven optimization and documented.
* Memory: each sample's trace is wrapped in `jax.checkpoint`
  (models/renderer.py:render_light_tile, cfg.remat=True) so the backward
  pass recomputes trajectories instead of storing every bounce's ray
  state, so device memory holds one sample's residuals at a time.
"""
from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from fourd_ray_tracing_tpu.camera import Camera
from fourd_ray_tracing_tpu.models.renderer import (
    RenderConfig,
    primary_directions,
    render_image,
    screen_coords,
    _expand_cam_vec,
)
from fourd_ray_tracing_tpu.models.scene import Scene
from fourd_ray_tracing_tpu.ops.vec4 import Vec4, dot
from fourd_ray_tracing_tpu.parallel.mesh import sharded_render_image


def image_loss(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    seed,
    target: jnp.ndarray,
    mesh=None,
) -> jnp.ndarray:
    """MSE between the rendered (tone-mapped) image and a target."""
    if mesh is None:
        img = render_image(scene, camera, cfg, seed)
    else:
        img = sharded_render_image(scene, camera, cfg, seed, mesh)
    return jnp.mean((img - target) ** 2)


def render_grad(
    scene: Scene, camera: Camera, cfg: RenderConfig, seed, target, mesh=None
):
    """(loss, dLoss/dScene) at a fixed RNG seed."""
    return jax.value_and_grad(image_loss)(scene, camera, cfg, seed, target, mesh)


# --- Soft-silhouette boundary gradients --------------------------------------

def primary_coverage(
    center: Vec4, r, camera: Camera, cfg: RenderConfig, edge_width: float
) -> jnp.ndarray:
    """Differentiable per-pixel coverage of a sphere by the PRIMARY rays.

    alpha = sigmoid((r - d_perp) / edge_width) where d_perp is the
    perpendicular distance from the sphere center to the pixel's primary
    ray line (shader.frag:501-505 ray_drct); rays receding from the
    sphere (b < 0, origin outside) get alpha -> 0 through the same
    sigmoid on the approach margin. Shape (H, W) (or (V, H, W) for a
    view-batched camera), values in (0, 1).
    """
    scr_x, scr_y = screen_coords(cfg)
    d = primary_directions(camera, scr_x, scr_y)
    o = _expand_cam_vec(camera.focus, d.x.ndim)
    po = center - Vec4(*(jnp.broadcast_to(c, d.x.shape) for c in o))
    b = dot(po, d)
    l2 = dot(po, po)
    perp2 = jnp.maximum(l2 - b * b, 0.0)
    perp = jnp.sqrt(perp2 + 1e-20)
    inv_w = 1.0 / jnp.asarray(edge_width, jnp.float32)
    alpha = jax.nn.sigmoid((r - perp) * inv_w)
    # Receding rays can't see the sphere: gate on the approach margin so
    # the gate itself is differentiable and saturates away from the edge.
    approaching = jax.nn.sigmoid((b + r) * inv_w)
    inside = l2 < r * r  # camera inside the sphere: fully covered
    return jnp.where(inside, jnp.ones_like(alpha), alpha * approaching)


def drop_sphere(scene: Scene, sphere_index: int) -> Scene:
    """The scene without sphere ``sphere_index`` (static restructure)."""
    spheres = tuple(
        s for k, s in enumerate(scene.spheres) if k != sphere_index
    )
    return scene._replace(spheres=spheres)


# --- Generalized per-primitive silhouette coverage ---------------------------
#
# Soft-silhouette gradients reach EVERY primitive family, not just
# spheres. Each coverage function below is a
# differentiable per-pixel alpha approximating "does the primary ray hit
# object X": sigmoid-relaxed versions of the same hit tests the hard
# renderer runs (shader.frag:189-400), so alpha saturates to the hard
# coverage away from the silhouette band and carries position/size
# gradients inside it. `object_coverage` / `drop_object` dispatch on an
# object reference (kind, index); `soft_image_loss` accepts either the
# legacy sphere_index or any object_ref.


def _primary_rays(camera: Camera, cfg: RenderConfig):
    scr_x, scr_y = screen_coords(cfg)
    d = primary_directions(camera, scr_x, scr_y)
    o = _expand_cam_vec(camera.focus, d.x.ndim)
    o = Vec4(*(jnp.broadcast_to(c, d.x.shape) for c in o))
    return o, d


def _sphere_coverage(center, r, o, d, inv_w):
    po = center - o
    b = dot(po, d)
    l2 = dot(po, po)
    perp2 = jnp.maximum(l2 - b * b, 0.0)
    perp = jnp.sqrt(perp2 + 1e-20)
    alpha = jax.nn.sigmoid((r - perp) * inv_w)
    approaching = jax.nn.sigmoid((b + r) * inv_w)
    inside = l2 < r * r
    return jnp.where(inside, jnp.ones_like(alpha), alpha * approaching)


def _cylinder_coverage(spec, o, d, inv_w):
    """Circle coverage in the plane orthogonal to both axes
    (shader.frag:243-267 relaxed): perpendicular distance of the
    projected ray line to the circle center."""
    from fourd_ray_tracing_tpu.ops import geometry as geo

    fam = geo._cyl_family(spec.point, spec.axis1, spec.axis2, o, d)
    perp = jnp.sqrt(jnp.maximum(fam.perp2, 0.0) + 1e-20)
    alpha = jax.nn.sigmoid((spec.r - perp) * inv_w)
    approaching = jax.nn.sigmoid((fam.b + spec.r) * inv_w)
    inside = fam.l2 < spec.r * spec.r
    return jnp.where(inside, jnp.ones_like(alpha), alpha * approaching)


def _duocylinder_coverage(cyl1, cyl2, o, d, inv_w):
    """Each face's circle coverage gated by a soft clip against the
    other cylinder (shader.frag:279-294 relaxed; squared-space widths
    scaled by 2r so the band is ~edge_width in distance units)."""
    from fourd_ray_tracing_tpu.ops import geometry as geo

    fam1 = geo._cyl_family(cyl1.point, cyl1.axis1, cyl1.axis2, o, d)
    fam2 = geo._cyl_family(cyl2.point, cyl2.axis1, cyl2.axis2, o, d)

    def face(fam, other, r, clip_r):
        perp = jnp.sqrt(jnp.maximum(fam.perp2, 0.0) + 1e-20)
        circ = jax.nn.sigmoid((r - perp) * inv_w)
        circ = jnp.where(fam.l2 < r * r, jnp.ones_like(circ), circ)
        dist, _hit, _ = geo._family_circle_dist(fam, r, True)
        clip_sq = geo._family_clip_sq(other, dist)
        inv_w_sq = inv_w / (2.0 * clip_r + 1e-20)
        return circ * jax.nn.sigmoid((clip_r * clip_r - clip_sq) * inv_w_sq)

    a1 = face(fam1, fam2, cyl1.r, cyl2.r)
    a2 = face(fam2, fam1, cyl2.r, cyl2.r)  # cyl2.r clip quirk (C6i)
    return a1 + a2 - a1 * a2


def _hypercube_coverage(hc, o, d, inv_w):
    """Soft union of the 8 cells: each cell's hyperplane facing and the
    three extent tests relaxed to sigmoids (shader.frag:344-400)."""
    c, axes, r = hc.point, hc.axes, hc.r
    co = [dot(c - o, a) for a in axes]
    dd = [dot(d, a) for a in axes]
    alpha = None
    for sign in (1.0, -1.0):
        for i in range(4):
            h = -(co[i] + r) if sign > 0 else co[i] - r
            cos_dn = -dd[i] if sign > 0 else dd[i]
            denom = jnp.where(jnp.abs(cos_dn) < 1e-6, 1e-6, cos_dn)
            dist = jnp.maximum(h, 0.0) / jnp.abs(denom)
            a_cell = jax.nn.sigmoid(h * inv_w) * jnp.where(
                cos_dn > 0.0, 1.0, 0.0
            )
            for j in range(4):
                if j == i:
                    continue
                e = dist * dd[j] - co[j]
                a_cell = a_cell * jax.nn.sigmoid((r - jnp.abs(e)) * inv_w)
            alpha = a_cell if alpha is None else alpha + a_cell - alpha * a_cell
    return alpha


def _tiger_coverage(tg, o, d, inv_w):
    """Outer faces of both cylinder families, soft-clipped to the other
    family's annulus (shader.frag:297-341 relaxed)."""
    from fourd_ray_tracing_tpu.ops import geometry as geo

    fam_a = geo._cyl_family(
        tg.outer_cyl1.point, tg.outer_cyl1.axis1, tg.outer_cyl1.axis2, o, d
    )
    fam_b = geo._cyl_family(
        tg.outer_cyl2.point, tg.outer_cyl2.axis1, tg.outer_cyl2.axis2, o, d
    )

    def face(fam, other, r_out, o_in, o_out):
        perp = jnp.sqrt(jnp.maximum(fam.perp2, 0.0) + 1e-20)
        circ = jax.nn.sigmoid((r_out - perp) * inv_w)
        circ = jnp.where(fam.l2 < r_out * r_out, jnp.ones_like(circ), circ)
        dist, _hit, _ = geo._family_circle_dist(fam, r_out, True)
        clip_sq = geo._family_clip_sq(other, dist)
        inv_w_sq = inv_w / (2.0 * o_out + 1e-20)
        soft = jax.nn.sigmoid((o_out * o_out - clip_sq) * inv_w_sq)
        soft = soft * jax.nn.sigmoid((clip_sq - o_in * o_in) * inv_w_sq)
        return circ * soft

    a1 = face(fam_a, fam_b, tg.outer_cyl1.r, tg.inner_cyl2.r, tg.outer_cyl2.r)
    a2 = face(fam_b, fam_a, tg.outer_cyl2.r, tg.inner_cyl1.r, tg.outer_cyl1.r)
    return a1 + a2 - a1 * a2


def _plane_coverage(sp, o, d, inv_w):
    """Double-sided hyperplane: hit iff the ray heads toward the plane
    (shader.frag:225-239); the product s*cos relaxes it, carrying point
    gradients near the horizon band."""
    s = dot(sp.point - o, sp.norm)
    cos_n = dot(d, sp.norm)
    return jax.nn.sigmoid(s * cos_n * inv_w * 4.0)


def object_coverage(
    scene: Scene, object_ref, camera: Camera, cfg: RenderConfig,
    edge_width: float,
) -> jnp.ndarray:
    """Differentiable primary-ray coverage of one scene object.

    ``object_ref``: ("spheres", i) | ("spaces", i) | ("cylinders", i) |
    ("cylinders_union", None) | ("hypercube", None) | ("tiger", None).
    Shape (H, W) (or (V, H, W)), values in (0, 1)."""
    kind, idx = object_ref
    o, d = _primary_rays(camera, cfg)
    inv_w = 1.0 / jnp.asarray(edge_width, jnp.float32)
    if kind == "spheres":
        sp = scene.spheres[idx]
        return _sphere_coverage(sp.center, sp.r, o, d, inv_w)
    if kind == "spaces":
        return _plane_coverage(scene.spaces[idx], o, d, inv_w)
    if kind == "cylinders":
        return _cylinder_coverage(scene.cylinders[idx], o, d, inv_w)
    if kind == "cylinders_union":
        c1, c2 = scene.cylinders_union
        return _duocylinder_coverage(c1, c2, o, d, inv_w)
    if kind == "hypercube":
        return _hypercube_coverage(scene.hypercube, o, d, inv_w)
    if kind == "tiger":
        return _tiger_coverage(scene.tiger, o, d, inv_w)
    raise ValueError(f"unknown object kind: {kind!r}")


def drop_object(scene: Scene, object_ref) -> Scene:
    """The scene without the referenced object (static restructure)."""
    kind, idx = object_ref
    if kind in ("spheres", "spaces", "cylinders"):
        items = getattr(scene, kind)
        return scene._replace(
            **{kind: tuple(x for k, x in enumerate(items) if k != idx)}
        )
    if kind in ("cylinders_union", "hypercube", "tiger"):
        return scene._replace(**{kind: None})
    raise ValueError(f"unknown object kind: {kind!r}")


def soft_image_loss(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    seed,
    target: jnp.ndarray,
    sphere_index: int = 0,
    edge_width: float = 0.05,
    mesh=None,
    object_ref=None,
) -> jnp.ndarray:
    """MSE with soft-silhouette gradients for one designated object.

    Renders (scene) and (scene minus the object) at the same seed and
    blends them with `object_coverage`; the gradient w.r.t. the object's
    position/size then carries the boundary term the plain estimator
    drops. ~2x forward cost; training-only (the forward image differs
    from the hard render only inside the edge band).

    ``object_ref`` selects ANY primitive — ("spheres", i), ("spaces", i),
    ("cylinders", i), ("cylinders_union", None), ("hypercube", None),
    ("tiger", None); default ("spheres", sphere_index) preserves the
    original sphere-only API.
    """
    if object_ref is None:
        object_ref = ("spheres", sphere_index)
    without = drop_object(scene, object_ref)
    if mesh is None:
        img_with = render_image(scene, camera, cfg, seed)
        img_without = render_image(without, camera, cfg, seed)
    else:
        img_with = sharded_render_image(scene, camera, cfg, seed, mesh)
        img_without = sharded_render_image(without, camera, cfg, seed, mesh)
    alpha = object_coverage(scene, object_ref, camera, cfg, edge_width)[..., None]
    img = alpha * img_with + (1.0 - alpha) * img_without
    return jnp.mean((img - target) ** 2)


def frame_seeds(seed, frames: int):
    """The F per-frame seeds a minibatch step derives from its scalar
    seed: ``seed * F + arange(F)``, so consecutive steps never share a
    frame."""
    base = jnp.asarray(seed, jnp.uint32) * np.uint32(frames)
    return base + jnp.arange(frames, dtype=jnp.uint32)


def minibatch_loss(loss_fn: Callable, frames: int) -> Callable:
    """``loss_fn(scene, seed, target)`` averaged over ``frames``
    independent estimator samples (`frame_seeds`) in one jit. The frames
    run in sequence (`lax.map`), so device memory holds one frame's
    residuals at a time. ``frames == 1`` returns ``loss_fn`` itself."""
    if frames <= 1:
        return loss_fn

    def mean_loss(scene, seed, target):
        losses = jax.lax.map(
            lambda s: loss_fn(scene, s, target), frame_seeds(seed, frames)
        )
        return jnp.mean(losses)

    return mean_loss


def _train_loss(cfg, camera, mesh, soft_sphere_index, edge_width,
                soft_object_ref, frames_per_step):
    """loss(scene, seed, target) shared by both train-step builders."""
    soft = soft_object_ref is not None or soft_sphere_index is not None

    def loss_fn(scene, seed, target):
        if not soft:
            return image_loss(scene, camera, cfg, seed, target, mesh)
        return soft_image_loss(
            scene, camera, cfg, seed, target, soft_sphere_index or 0,
            edge_width, mesh, object_ref=soft_object_ref,
        )

    return minibatch_loss(loss_fn, frames_per_step)


def make_train_step(
    cfg: RenderConfig,
    optimizer: optax.GradientTransformation,
    camera: Camera,
    mesh=None,
    param_filter: Optional[Callable] = None,
    soft_sphere_index: Optional[int] = None,
    edge_width: float = 0.05,
    soft_object_ref=None,
    frames_per_step: int = 1,
):
    """Jitted inverse-rendering step: optimize scene params toward target
    images (SURVEY §7 step 5; BASELINE.json config 5). The gradient is
    `jax.value_and_grad` of the jnp pipeline.

    ``param_filter(grads)`` may zero out gradients of parameters that
    should stay frozen (e.g. wall positions while fitting a sphere).
    ``soft_sphere_index`` switches the loss to `soft_image_loss` for that
    sphere, enabling silhouette (position/radius) gradients;
    ``soft_object_ref`` does the same for ANY primitive (see
    `object_coverage`).
    When a mesh is given, rays/samples shard across it and the scene
    gradient arrives via the AD transpose of the replicated inputs: an
    all-reduce across the devices, fused into the backward pass.
    ``frames_per_step`` > 1 averages that many independent estimator
    samples per optimizer step (`minibatch_loss`): lower-variance
    gradients for F times the rays.

    Returns a step whose metrics dict carries loss and the global
    gradient norm (SURVEY §5 metrics/logging).
    """
    loss_fn = _train_loss(cfg, camera, mesh, soft_sphere_index, edge_width,
                          soft_object_ref, frames_per_step)

    @jax.jit
    def step(scene, opt_state, seed, target):
        loss, grads = jax.value_and_grad(loss_fn)(scene, seed, target)
        if param_filter is not None:
            grads = param_filter(grads)
        grad_norm = optax.global_norm(grads)
        updates, opt_state = optimizer.update(grads, opt_state, scene)
        scene = optax.apply_updates(scene, updates)
        return scene, opt_state, loss, {"loss": loss, "grad_norm": grad_norm}

    return step


def make_packed_train_step(
    cfg: RenderConfig,
    optimizer: optax.GradientTransformation,
    camera: Camera,
    scene_template: Scene,
    param_filter: Optional[Callable] = None,
    frames_per_step: int = 1,
    mesh=None,
):
    """The train loop with the optimizer in packed vector space: the
    whole training state is ONE flat (n_scene,) float32 vector, so adam
    is one fused elementwise chain instead of one update per scene leaf
    (~100-250 leaves), and the state checkpoints as one array
    (`utils.checkpoint.save_train_state`). The loss and gradient are
    `jax.value_and_grad` of the same loss as `make_train_step` composed
    with ``unpack``; ``frames_per_step`` and ``mesh`` mean the same.

    Returns ``(step, init, unpack)``:

    * ``init(scene) -> (scene_vec, opt_state)``
    * ``step(scene_vec, opt_state, seed, target) ->
      (scene_vec, opt_state, loss)`` — jitted; scan-friendly
    * ``unpack(scene_vec) -> Scene`` — materialize the pytree (for
      checkpointing / rendering outside the loop)

    ``scene_template`` fixes the static scene structure.
    ``param_filter`` (same contract as make_train_step's: a pytree ->
    pytree gradient zero-mask) becomes a static packed 0/1 vector
    applied to the gradient before the optimizer.
    """
    leaves, treedef = jax.tree_util.tree_flatten(scene_template)
    shapes = [jnp.shape(l) for l in leaves]
    sizes = [int(np.prod(s)) for s in shapes]

    def pack(scene: Scene):
        return jnp.concatenate([
            jnp.asarray(l, jnp.float32).reshape(-1)
            for l in jax.tree_util.tree_leaves(scene)
        ])

    def unpack(scene_vec):
        out, off = [], 0
        for shape, size in zip(shapes, sizes):
            out.append(scene_vec[off:off + size].reshape(shape))
            off += size
        return jax.tree_util.tree_unflatten(treedef, out)

    filter_vec = None
    if param_filter is not None:
        ones = jax.tree_util.tree_map(
            lambda l: jnp.ones_like(jnp.asarray(l, jnp.float32)),
            scene_template,
        )
        filter_vec = pack(param_filter(ones))

    loss_fn = _train_loss(cfg, camera, mesh, None, 0.05, None,
                          frames_per_step)

    def init(scene: Scene):
        vec = pack(scene)
        return vec, optimizer.init(vec)

    @jax.jit
    def step(scene_vec, opt_state, seed, target):
        loss, g = jax.value_and_grad(
            lambda v: loss_fn(unpack(v), seed, target)
        )(scene_vec)
        if filter_vec is not None:
            g = g * filter_vec
        updates, opt_state = optimizer.update(g, opt_state, scene_vec)
        scene_vec = optax.apply_updates(scene_vec, updates)
        return scene_vec, opt_state, loss

    return step, init, unpack


def finite_difference_grad(
    f: Callable[[jnp.ndarray], jnp.ndarray], x0: jnp.ndarray, eps: float = 1e-3
) -> jnp.ndarray:
    """Central finite differences for gradient tests (SURVEY §4.4)."""
    x0 = jnp.asarray(x0, jnp.float32)
    flat = x0.reshape(-1)
    grads = []
    for i in range(flat.size):
        dx = jnp.zeros_like(flat).at[i].set(eps)
        fp = f((flat + dx).reshape(x0.shape))
        fm = f((flat - dx).reshape(x0.shape))
        grads.append((fp - fm) / (2 * eps))
    return jnp.stack(grads).reshape(x0.shape)
