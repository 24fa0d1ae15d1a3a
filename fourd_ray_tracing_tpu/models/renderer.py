"""The forward path tracer: camera rays -> bounce loop -> tone map.

This is the executable spec (SURVEY §4.1's "golden-image oracle") and at
the same time the production differentiable forward: a pure jnp pipeline
over SoA ray batches that runs on the CPU (tests) and the GPU via
jit/XLA fusion. The forward kernel (ops/pallas/megakernel.py) runs
`precompute_bounce0` and `trace_rays` themselves on per-block pixel
vectors, so the two compute the same ops.

Behavior contract (reference = shader.frag:471-528):

* bounce loop runs reflections_amount+1 times; a miss adds
  throughput * final_light and terminates the lane; bounce exhaustion
  adds nothing (darkening = shadows);
* emission adds color*glow*throughput BEFORE absorption multiplies
  throughput by color;
* next origin steps dist along the ray plus small_indent along the hit
  normal;
* per bounce one Bernoulli draw chooses mirror (u <= refl_prob) vs
  diffuse; diffuse draws three more uniforms for the S^3 sampler;
  terminated/mirror lanes do not advance their RNG counters, so lane
  streams equal the reference's sequential call streams;
* all samples of a pixel share one primary direction (no sub-pixel
  jitter; ray_drct computed once, shader.frag:519), and the RNG counter
  carries across the sample loop (rand_iter_seed is per-fragment state,
  shader.frag:92);
* screen convention: pixel (row i, col j) of an HxW image has
  scr = ((j+.5)/W, (i+.5)/H) with row 0 at the TOP of the image, and
  film coords mx = (scr.x-.5)*mtr_w, my = (.5-scr.y)*mtr_h
  (shader.frag:502 with y measured from the top).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from fourd_ray_tracing_tpu.camera import Camera
from fourd_ray_tracing_tpu.models.scene import Scene, intersect_scene
from fourd_ray_tracing_tpu.ops import rng
from fourd_ray_tracing_tpu.ops.sampler import direction_from_uniforms
from fourd_ray_tracing_tpu.ops.sky import final_light, light_to_color
from fourd_ray_tracing_tpu.ops.vec4 import Vec3, Vec4, normalize, redirect, reflect


@dataclass(frozen=True)
class RenderConfig:
    """Static render parameters (the reference's static uniforms,
    main.cpp:28-38 + window cell resolution)."""

    width: int = 256
    height: int = 256
    samples: int = 1
    reflections_amount: int = 4
    small_indent: float = 0.005
    light_coefficient: float = 1.0
    # "poly" (polynomial inverse-CDF, <5e-6 error; the default),
    # "kepler" (Halley iterations), "newton" (reference-exact loop).
    sampler_method: str = "poly"
    # Halley iterations for the Kepler inverse-CDF; 2 already reaches the
    # float32 rounding floor (~1e-5, see ops/sampler.py).
    sampler_iters: int = 2
    # RNG stream layout:
    #  "sequential" — the reference's per-pixel counter carried across the
    #    sample loop (shader.frag:92): bit-exact vs the oracle, but samples
    #    of one pixel are sequentially dependent, so the sample axis cannot
    #    shard across devices.
    #  "per_sample" — each (pixel, sample) pair owns an independent stream
    #    keyed by absolute sample index: statistically identical, and the
    #    image is bit-identical for ANY sharding of pixels/samples
    #    (SURVEY §4.6 determinism-across-devices requirement).
    rng_mode: str = "sequential"
    # Scene intersection implementation: "fast" (fused dist-fold +
    # deferred winner resolve, models/scene.py:intersect_scene_fast) or
    # "spec" (literal per-primitive closest-fold; mask edges can differ
    # at ulp level).
    intersect: str = "fast"
    # Rematerialize each sample's trace in the backward pass
    # (jax.checkpoint): the gradient recomputes ray trajectories instead
    # of storing every bounce's ray state per sample, so device memory
    # holds one sample's residuals at a time. Forward-only cost: none.
    remat: bool = True
    # Static zero-component hints for hyperplane normals (fast intersect
    # only): tuple of per-space (zx, zy, zz, zw) bools from
    # models.scene.plane_norm_hints, or None. Forward-identical (skipped
    # terms are exact float32 zeros); derived by the forward kernel's
    # entry point (megakernel.with_static_hints), never by the
    # jnp/autodiff path (hinted normal components would get zero
    # gradients).
    plane_hints: tuple | None = None
    # Static opposite-wall pairs ((pairs, singles) from
    # models.scene.plane_pair_hints): closed-box scenes fold each wall
    # pair as ONE candidate (one division + fold step instead of two).
    # Same production-only contract as plane_hints.
    plane_pairs: tuple | None = None
    # Static axis-alignment hints for cylinder families / hypercube axes
    # (models.scene.axis_alignment_hints): unit-basis axes collapse the
    # projection dots to component picks. Same production-only contract
    # as plane_hints (dropped terms would get zero gradients).
    axis_hints: tuple | None = None


def screen_coords(cfg: RenderConfig, row0=0, n_rows: int | None = None):
    """Normalized pixel-center coordinates, row 0 = top.

    ``row0`` (traced or static) and ``n_rows`` (static) select a block of
    image rows — the unit of pixel sharding and kernel tiling. The
    normalization always uses the GLOBAL resolution, so a pixel's
    coordinates (and hence its RNG stream, shader.frag:106-107) do not
    depend on how the image was tiled.
    """
    if n_rows is None:
        n_rows = cfg.height
    j = jnp.arange(cfg.width, dtype=jnp.float32)
    i = jnp.arange(n_rows, dtype=jnp.float32) + jnp.asarray(row0, jnp.float32)
    scr_x = (j[None, :] + 0.5) / jnp.float32(cfg.width)
    scr_y = (i[:, None] + 0.5) / jnp.float32(cfg.height)
    scr_x = jnp.broadcast_to(scr_x, (n_rows, cfg.width))
    scr_y = jnp.broadcast_to(scr_y, (n_rows, cfg.width))
    return scr_x, scr_y


def _expand_cam_vec(v: Vec4, target_ndim: int) -> Vec4:
    """Right-pad camera vector components with singleton axes so a
    (V,)-batched basis broadcasts against (V, H, W) pixel grids."""

    def expand(c):
        c = jnp.asarray(c, jnp.float32)
        while c.ndim < target_ndim:
            c = c[..., None]
        return c

    return Vec4(expand(v.x), expand(v.y), expand(v.z), expand(v.w))


def primary_directions(camera: Camera, scr_x, scr_y) -> Vec4:
    """ray_drct (shader.frag:501-505): normalize(vec_to_mtr + top*my + right*mx)."""
    view_batched = jnp.asarray(camera.top.x).ndim > 0
    target = scr_x.ndim + (1 if view_batched else 0)
    top = _expand_cam_vec(camera.top, target)
    right = _expand_cam_vec(camera.right, target)
    vec_to_mtr = _expand_cam_vec(camera.vec_to_mtr, target)
    mx = (scr_x - 0.5) * camera.mtr_width
    my = (0.5 - scr_y) * camera.mtr_height
    return normalize(vec_to_mtr + top * my + right * mx)


class Bounce0(NamedTuple):
    """Sample-invariant state after bounce 0 (precompute_bounce0).

    All samples of a pixel share one primary ray (shader.frag:519), so
    everything bounce 0 computes EXCEPT the stochastic direction update
    — intersection, env/emission shading, throughput, the stepped
    origin, even the mirror reflection of the primary direction — is
    identical across the sample loop. The caller hoists it out and pays
    it once per pixel instead of once per sample; trace_rays resumes
    from bounce 1 with only the per-sample RNG draws and the direction
    select left to do. Bit-identical results (same ops, same order).
    """

    result: "Vec3"        # emission (+escaped env) collected at bounce 0
    throughput: "Vec3"
    o: "Vec4"             # origin stepped to the bounce-0 hit
    alive_f: jnp.ndarray  # 1.0 where bounce 0 hit
    mirrored: "Vec4"      # reflect(primary_d, norm0)
    refl_prob: jnp.ndarray
    norm: "Vec4"


def precompute_bounce0(
    scene: Scene, ray_o: Vec4, ray_d: Vec4, cfg: RenderConfig
) -> Bounce0:
    """The sample-invariant half of bounce 0 (see Bounce0).

    Op-for-op the same computation the first trace_rays iteration used
    to perform with an all-true alive mask, so hoisting it preserves
    bit-exact images in both RNG modes.
    """
    o, d = ray_o, ray_d
    inter = intersect_scene(
        scene, o, d, cfg.intersect,
        plane_hints=cfg.plane_hints, plane_pairs=cfg.plane_pairs,
        axis_hints=cfg.axis_hints,
    )
    zero3 = Vec3.full(0.0, like=jnp.zeros(d.x.shape, jnp.float32))
    result = zero3
    if scene.environment is not None and scene.environment.enabled:
        escaped = jnp.logical_not(inter.hit)
        env = final_light(scene.environment, d)
        result = result + env.where(escaped, zero3)
    alive = inter.hit
    result = result + (inter.color * inter.glow).where(alive, zero3)
    throughput = inter.color.where(alive, Vec3.full(1.0, like=zero3.x))
    new_o = o + d * inter.dist + inter.norm * jnp.float32(cfg.small_indent)
    o = new_o.where(alive, o)
    return Bounce0(
        result=result,
        throughput=throughput,
        o=o,
        alive_f=jnp.where(alive, 1.0, 0.0),
        mirrored=reflect(d, inter.norm),
        refl_prob=inter.refl_prob,
        norm=inter.norm,
    )


def bounce0_direction_update(
    pre0: Bounce0,
    ray_d: Vec4,
    pixel_bits: jnp.ndarray,
    seed: jnp.ndarray,
    counter: jnp.ndarray,
    cfg: RenderConfig,
):
    """Bounce 0's per-sample direction update (shader.frag:488-491) — the
    only non-hoistable piece of bounce 0 (see Bounce0). Shared op-for-op
    by the jnp renderer and the forward kernel through trace_rays.
    Returns (new_d, counter)."""
    alive = pre0.alive_f > 0.5
    u_refl, counter = rng.masked_uniform01(pixel_bits, seed, counter, alive)
    mirror = u_refl <= pre0.refl_prob
    diffuse = jnp.logical_and(alive, jnp.logical_not(mirror))
    u_w, counter = rng.masked_uniform01(pixel_bits, seed, counter, diffuse)
    u_z, counter = rng.masked_uniform01(pixel_bits, seed, counter, diffuse)
    u_fi, counter = rng.masked_uniform01(pixel_bits, seed, counter, diffuse)
    rand_dir = direction_from_uniforms(
        u_w, u_z, u_fi, method=cfg.sampler_method,
        kepler_iters=cfg.sampler_iters,
    )
    scattered = redirect(rand_dir, pre0.norm)
    d = pre0.mirrored.where(mirror, scattered).where(alive, ray_d)
    return d, counter


def trace_rays(
    scene: Scene,
    ray_o: Vec4,
    ray_d: Vec4,
    pixel_bits: jnp.ndarray,
    seed: jnp.ndarray,
    counter: jnp.ndarray,
    cfg: RenderConfig,
    pre0: Bounce0 | None = None,
):
    """One sample per lane: the trace() loop (shader.frag:471-495).

    Returns (light: Vec3, advanced counter). Masked-lane form of the
    scalar reference loop; RNG counters advance only where the scalar
    code would call rand().

    ``pre0`` optionally supplies the hoisted sample-invariant bounce-0
    state (precompute_bounce0): the loop then starts at bounce 1 after
    performing only bounce 0's per-sample direction update —
    bit-identical results at one bounce-0 shade per PIXEL instead of
    per sample.
    """
    o, d = ray_o, ray_d
    result = Vec3.full(0.0, like=jnp.zeros(pixel_bits.shape, jnp.float32))
    throughput = Vec3.full(1.0, like=result.x)
    alive = jnp.zeros(pixel_bits.shape, jnp.float32) < 1.0
    start_bounce = 0

    if pre0 is not None:
        alive = pre0.alive_f > 0.5
        result = pre0.result
        throughput = pre0.throughput
        o = pre0.o
        if cfg.reflections_amount == 0:
            # Bounce 0 is the final iteration: shade only, but a
            # sequential stream still pays the reference's dead
            # final-iteration draws (shader.frag:488-491).
            if cfg.rng_mode == "sequential":
                u_refl, counter = rng.masked_uniform01(
                    pixel_bits, seed, counter, alive
                )
                diffuse = jnp.logical_and(alive, u_refl > pre0.refl_prob)
                for _ in range(3):
                    _, counter = rng.masked_uniform01(
                        pixel_bits, seed, counter, diffuse
                    )
            return result, counter
        d, counter = bounce0_direction_update(
            pre0, d, pixel_bits, seed, counter, cfg
        )
        start_bounce = 1

    for bounce in range(start_bounce, cfg.reflections_amount + 1):
        inter = intersect_scene(
            scene, o, d, cfg.intersect,
            plane_hints=cfg.plane_hints, plane_pairs=cfg.plane_pairs,
            axis_hints=cfg.axis_hints,
        )

        env_on = scene.environment is not None and scene.environment.enabled
        if env_on:  # static: disabled env compiles away (room scene)
            escaped = jnp.logical_and(alive, jnp.logical_not(inter.hit))
            env = final_light(scene.environment, d)
            add_env = (throughput * env).where(escaped, Vec3.full(0.0, like=result.x))
            result = result + add_env

        alive = jnp.logical_and(alive, inter.hit)

        glow_add = (inter.color * inter.glow * throughput).where(
            alive, Vec3.full(0.0, like=result.x)
        )
        result = result + glow_add
        throughput = (throughput * inter.color).where(alive, throughput)

        new_o = o + d * inter.dist + inter.norm * jnp.float32(cfg.small_indent)
        o = new_o.where(alive, o)

        if bounce == cfg.reflections_amount:
            # The final iteration's direction is never used, but the
            # reference still draws for it (the update sits inside the
            # loop, shader.frag:488-491): 1 Bernoulli + 3 sampler calls
            # on live diffuse lanes. A sequential stream carries across
            # the sample loop (shader.frag:92), so those draws shift the
            # NEXT sample's stream — advance the counters, skip the
            # direction math. Per-sample streams reset each sample, so
            # they skip this dead work entirely.
            if cfg.rng_mode == "sequential":
                u_refl, counter = rng.masked_uniform01(
                    pixel_bits, seed, counter, alive
                )
                diffuse = jnp.logical_and(alive, u_refl > inter.refl_prob)
                for _ in range(3):
                    _, counter = rng.masked_uniform01(
                        pixel_bits, seed, counter, diffuse
                    )
            break

        u_refl, counter = rng.masked_uniform01(pixel_bits, seed, counter, alive)
        mirror = u_refl <= inter.refl_prob

        diffuse = jnp.logical_and(alive, jnp.logical_not(mirror))
        u_w, counter = rng.masked_uniform01(pixel_bits, seed, counter, diffuse)
        u_z, counter = rng.masked_uniform01(pixel_bits, seed, counter, diffuse)
        u_fi, counter = rng.masked_uniform01(pixel_bits, seed, counter, diffuse)
        rand_dir = direction_from_uniforms(
            u_w, u_z, u_fi, method=cfg.sampler_method,
            kepler_iters=cfg.sampler_iters,
        )

        mirrored = reflect(d, inter.norm)
        scattered = redirect(rand_dir, inter.norm)
        new_d = mirrored.where(mirror, scattered)
        d = new_d.where(alive, d)

    return result, counter


def sample_stream_bits(pixel_bits: jnp.ndarray, sample_index) -> jnp.ndarray:
    """Independent per-(pixel, sample) stream key for rng_mode="per_sample"."""
    fold = rng.hash_u32(
        (jnp.asarray(sample_index, jnp.uint32) + jnp.uint32(1)) * jnp.uint32(0x9E3779B9)
    )
    return pixel_bits ^ fold


def render_light_tile(
    scene: Scene,
    camera: Camera,
    cfg: RenderConfig,
    seed,
    row0=0,
    n_rows: int | None = None,
    sample0=0,
    n_samples: int | None = None,
    vary_axes: tuple = (),
) -> jnp.ndarray:
    """Light for a block of image rows and a block of samples.

    The unit of device sharding (parallel/mesh.py). Row/sample offsets are absolute, so any partition of
    (rows x samples) over devices reassembles into the same image
    (requires rng_mode="per_sample" when the sample axis is split).
    Returns (..., n_rows, W, 3) light SUMMED over the local samples
    (caller divides by the GLOBAL sample count).

    ``vary_axes``: when called inside shard_map, the mesh axis names this
    tile varies over — the loop-carried accumulator starts as a constant
    and must be explicitly cast to device-varying for shard_map's
    replication checker (check_vma) to type the sample fori_loop.
    """
    if (cfg.plane_hints is not None or cfg.plane_pairs is not None
            or cfg.axis_hints is not None):
        # Hints zero out gradients w.r.t. the hinted components; they
        # are an internal detail of the (forward-only) kernel entry
        # point and must never reach the jnp/autodiff pipeline.
        raise ValueError(
            "plane_hints/plane_pairs/axis_hints are kernel-internal; the "
            "jnp renderer (autodiff path) must run without hints"
        )
    if n_rows is None:
        n_rows = cfg.height
    if n_samples is None:
        n_samples = cfg.samples
    seed = jnp.asarray(seed, jnp.uint32)
    scr_x, scr_y = screen_coords(cfg, row0, n_rows)
    d = primary_directions(camera, scr_x, scr_y)
    pixel_bits = rng.pixel_stream_bits(scr_x, scr_y)
    pixel_bits = jnp.broadcast_to(pixel_bits, d.x.shape)
    o = _expand_cam_vec(camera.focus, d.x.ndim)
    o = Vec4(*(jnp.broadcast_to(c, d.x.shape) for c in o))

    counter0 = rng.init_counter(seed, pixel_bits.shape)
    zero3 = Vec3.full(0.0, like=jnp.zeros(d.x.shape, jnp.float32))
    if vary_axes:
        # Explicitly device-varying initial carry (see docstring).
        zero3, counter0 = jax.lax.pcast((zero3, counter0), vary_axes, to="varying")
    # All samples share the primary ray (shader.frag:519) — hoist the
    # sample-invariant bounce-0 intersection AND shading out of the
    # sample loop (precompute_bounce0; bit-identical).
    pre0 = precompute_bounce0(scene, o, d, cfg)

    # Backward-pass rematerialization: recompute each sample's bounce
    # trajectory instead of saving per-bounce ray state (diff.py).
    traced = (
        jax.checkpoint(trace_rays, static_argnums=(6,)) if cfg.remat else trace_rays
    )

    if cfg.rng_mode == "per_sample":
        sample0 = jnp.asarray(sample0, jnp.uint32)

        def sample_body(s, state):
            acc, counter = state
            bits = sample_stream_bits(pixel_bits, sample0 + jnp.uint32(s))
            light, _ = traced(scene, o, d, bits, seed, counter0, cfg, pre0)
            return acc + light, counter

    else:
        if not (isinstance(sample0, int) and sample0 == 0):
            raise ValueError(
                'rng_mode="sequential" carries RNG state across samples and '
                'cannot start mid-stream; use rng_mode="per_sample" to shard '
                "the sample axis."
            )

        def sample_body(s, state):
            acc, counter = state
            light, counter = traced(
                scene, o, d, pixel_bits, seed, counter, cfg, pre0
            )
            return acc + light, counter

    acc, _ = jax.lax.fori_loop(0, n_samples, sample_body, (zero3, counter0))
    return acc.stack(axis=-1)


def render_light(scene: Scene, camera: Camera, cfg: RenderConfig, seed) -> jnp.ndarray:
    """Average light over the sample loop (shader.frag:520-522).

    Returns a float32 array (..., H, W, 3) of un-tonemapped light; a
    leading view axis appears iff the camera basis is view-batched.
    """
    acc = render_light_tile(scene, camera, cfg, seed)
    return acc * (1.0 / jnp.float32(cfg.samples))


def render_image(scene: Scene, camera: Camera, cfg: RenderConfig, seed) -> jnp.ndarray:
    """Tone-mapped color image in [0, 1), shape (..., H, W, 3)."""
    light = render_light(scene, camera, cfg, seed)
    color = light_to_color(
        Vec3(light[..., 0], light[..., 1], light[..., 2]),
        jnp.float32(cfg.light_coefficient),
    )
    return color.stack(axis=-1)


def accumulate(old_frame: jnp.ndarray, new_frame: jnp.ndarray, part) -> jnp.ndarray:
    """Progressive blend mix(old, new, part) (shader.frag:526-527);
    part = 1/frame_number while the camera is still (main.cpp:87)."""
    part = jnp.asarray(part, jnp.float32)
    return old_frame + (new_frame - old_frame) * part
