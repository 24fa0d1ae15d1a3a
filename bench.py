"""Benchmarks: rays/s on the canonical forward and training workloads.

Default (BENCH_MODE=full) runs every BASELINE.md workload:

  1. sphere_plane_light  256x256 x 1 spp x 2 bounces, single view
  2. room_with_sphere    1280x720 x 8 spp x 4 bounces  (the HEADLINE)
  3. hypercube           1280x720 x 8 spp x 4 bounces  (diffuse sampler hot)
  4. duocylinder+tiger   three simultaneous section views (xyz/ywz/yxw),
                         batched as a leading view axis in ONE launch
  5. inverse rendering   loss+grad and optimizer steps on room_with_sphere
                         (jax.value_and_grad of the jnp pipeline with
                         per-sample remat)

The forward workloads render through BENCH_IMPL ("auto": the Triton
kernel on a GPU, engine.resolve_impl). Each workload times BENCH_ROUNDS
rounds of BENCH_FRAMES launches after a warmup, each round ending in
`block_until_ready`, and reports min/median/max rays/s. Per-workload
JSON lines go to stdout, each naming the device; the FINAL line is the
headline (room-with-sphere median):

  {"metric": "rays_per_second", "value": N, "unit": "rays/s", ...}

Roofline accounting: FLOPs per traced path come from XLA's cost analysis
of the identical-math jnp pipeline (forward) or of its value-and-grad
(training). `mfu` divides the achieved rate by the device's fp32 rate
outside the tensor cores (PEAKS — the render has no matrix product).
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import time

import jax

from fourd_ray_tracing_tpu.utils.compile_cache import setup_compile_cache

setup_compile_cache()

import jax.numpy as jnp
import numpy as np

from fourd_ray_tracing_tpu import camera as cam
from fourd_ray_tracing_tpu.engine import resolve_impl
from fourd_ray_tracing_tpu.models import library
from fourd_ray_tracing_tpu.models.renderer import RenderConfig
from fourd_ray_tracing_tpu.ops.vec4 import Vec4

WIDTH = int(os.environ.get("BENCH_WIDTH", 1280))
HEIGHT = int(os.environ.get("BENCH_HEIGHT", 720))
SAMPLES = int(os.environ.get("BENCH_SAMPLES", 8))
BOUNCES = int(os.environ.get("BENCH_BOUNCES", 4))
FRAMES = int(os.environ.get("BENCH_FRAMES", 8))
ROUNDS = int(os.environ.get("BENCH_ROUNDS", 5))
SCENE = os.environ.get("BENCH_SCENE", "room_with_sphere")
MODE = os.environ.get("BENCH_MODE", "full")
IMPL = os.environ.get("BENCH_IMPL", "auto")  # engine.resolve_impl
SAMPLER = os.environ.get("BENCH_SAMPLER", "poly")
INTERSECT = os.environ.get("BENCH_INTERSECT", "fast")
SAMPLER_ITERS = int(os.environ.get("BENCH_SAMPLER_ITERS", 2))
TARGET_RAYS_PER_S = 1e9  # BASELINE.md:18

# Published peaks per device_kind (NVIDIA H100 data sheet, SXM part,
# dense rates at the full 700 W power limit): fp32 FLOP/s outside the
# tensor cores and HBM bytes/s. A device missing here is an error, not
# a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def device_peaks(device_kind: str) -> dict:
    """The PEAKS entry for ``device_kind``; raises for a device the
    table does not know."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device {device_kind!r}; add it to "
            "bench.PEAKS with its source"
        ) from None


def device_info() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def default_camera(views=("yxz",)):
    angles = cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0))
    if len(views) == 1:
        return cam.camera_from_state(
            focus=Vec4.of(0.0, -2.0, 0.0, 0.0), angles=angles,
            focus_to_matrix_distance=1.5, matrix_height=2.0, view=views[0],
        )
    orient = cam.orientation_from_angles(angles.fi, angles.te, angles.psi)
    tops, rights = cam.batched_view_bases(orient, views)
    return cam.Camera(
        focus=Vec4.of(0.0, -2.0, 0.0, 0.0),
        vec_to_mtr=orient.forward * jnp.float32(1.5),
        top=tops, right=rights,
        mtr_width=jnp.float32(2.0) * cam.GOLDEN, mtr_height=jnp.float32(2.0),
    )


def build_cfg(width, height, samples, bounces):
    return RenderConfig(
        width=width, height=height, samples=samples,
        reflections_amount=bounces, light_coefficient=0.12,
        sampler_method=SAMPLER, rng_mode="per_sample",
        sampler_iters=SAMPLER_ITERS, intersect=INTERSECT,
    )


def make_renderer(scene_name=None, cfg=None, views=("yxz",), impl=None,
                  frames_per_launch=1):
    """Jitted seed -> image(s). ``frames_per_launch`` > 1 renders that
    many whole frames (distinct seeds) per call: one kernel launch with
    a frame axis, or the frames in sequence inside one XLA program."""
    cfg = cfg or build_cfg(WIDTH, HEIGHT, SAMPLES, BOUNCES)
    scene = library.SCENES[scene_name or SCENE]()
    camera = default_camera(views)
    if resolve_impl(impl or IMPL) == "pallas":
        from fourd_ray_tracing_tpu.ops.pallas.megakernel import (
            render_image_pallas,
            with_static_hints,
        )

        cfg = with_static_hints(cfg, scene)
        render = lambda seeds: render_image_pallas(scene, camera, cfg, seeds)
    else:
        from fourd_ray_tracing_tpu.models.renderer import render_image

        render = lambda seeds: jax.lax.map(
            lambda s: render_image(scene, camera, cfg, s), seeds
        )
    k = np.uint32(frames_per_launch)
    return jax.jit(
        lambda seed: render(jnp.uint32(seed) * k + jnp.arange(k, dtype=jnp.uint32))
    )


def _cost_flops(compiled) -> float:
    analysis = compiled.cost_analysis()
    if isinstance(analysis, list):
        analysis = analysis[0]
    return float(analysis.get("flops", 0.0))


def flops_per_ray(scene_name, cfg, views=("yxz",)):
    """XLA cost analysis of the jnp pipeline at a tiny resolution ->
    FLOPs per traced path (the kernel runs the same ops). None if the
    backend exposes no analysis."""
    from fourd_ray_tracing_tpu.models.renderer import render_image

    small = dataclasses.replace(cfg, width=64, height=32)
    scene = library.SCENES[scene_name]()
    camera = default_camera(views)
    compiled = (
        jax.jit(lambda seed: render_image(scene, camera, small, seed))
        .lower(np.uint32(1)).compile()
    )
    flops = _cost_flops(compiled)
    rays = len(views) * small.width * small.height * small.samples
    return flops / rays if flops > 0 else None


def grad_flops_per_ray(cfg, scene_name="room_with_sphere", views=("yxz",)):
    """XLA cost analysis of the jnp value-and-grad at tiny resolution ->
    FLOPs per traced forward path of the loss+gradient (no remat, so
    recomputation is not counted)."""
    from fourd_ray_tracing_tpu.diff import image_loss

    small = dataclasses.replace(cfg, width=64, height=32, remat=False)
    scene = library.SCENES[scene_name]()
    camera = default_camera(views)
    target = jnp.zeros(_image_shape(views, small), jnp.float32)
    compiled = (
        jax.jit(lambda s, seed: jax.value_and_grad(image_loss)(
            s, camera, small, seed, target))
        .lower(scene, np.uint32(1)).compile()
    )
    flops = _cost_flops(compiled)
    rays = len(views) * small.width * small.height * small.samples
    return flops / rays if flops > 0 else None


def _image_shape(views, cfg):
    shape = (cfg.height, cfg.width, 3)
    return shape if len(views) == 1 else (len(views),) + shape


def time_rounds(fn, rays, frames=FRAMES, rounds=ROUNDS):
    """min/median/max rays/s over timing rounds (compile excluded); each
    round queues ``frames`` calls and waits with block_until_ready."""
    jax.block_until_ready(fn(np.uint32(1)))  # compile + warm
    rates = []
    for r in range(rounds):
        t0 = time.perf_counter()
        for i in range(frames):
            out = fn(np.uint32(100 * r + i + 2))
        jax.block_until_ready(out)
        rates.append(rays * frames / (time.perf_counter() - t0))
    return min(rates), statistics.median(rates), max(rates)


def emit(payload):
    print(json.dumps({**payload, "device": device_info()}), flush=True)


def _roofline(payload, rate, fpr):
    if fpr is None:
        return
    peak = device_peaks(jax.devices()[0].device_kind)["fp32_flops"]
    payload["flops_per_ray"] = round(fpr, 1)
    payload["achieved_gflops"] = round(rate * fpr / 1e9, 1)
    payload["mfu"] = round(rate * fpr / peak, 4)


def run_forward_workload(name, scene_name, width, height, samples, bounces,
                         views=("yxz",), frames_per_launch=1):
    cfg = build_cfg(width, height, samples, bounces)
    fn = make_renderer(scene_name, cfg, views,
                       frames_per_launch=frames_per_launch)
    rays = len(views) * width * height * samples * frames_per_launch
    out = jax.block_until_ready(fn(np.uint32(1)))
    assert bool(jnp.isfinite(out).all()), f"non-finite pixels in {name}"
    lo, med, hi = time_rounds(fn, rays)
    payload = {
        "metric": "rays_per_second", "workload": name, "scene": scene_name,
        "impl": resolve_impl(IMPL), "value": med, "min": lo, "max": hi,
        "unit": "rays/s", "rays_per_launch": rays,
        "frames_per_launch": frames_per_launch,
        "vs_baseline": med / TARGET_RAYS_PER_S,
    }
    _roofline(payload, med, flops_per_ray(scene_name, cfg, views))
    emit(payload)
    return med


def _train_payload(workload, med, lo, hi, rays, **extra):
    return {
        "metric": "grad_rays_per_second", "workload": workload,
        "scene": extra.pop("scene", "room_with_sphere"), "impl": "xla",
        "value": med, "min": lo, "max": hi, "unit": "rays/s",
        "rays_per_launch": rays, "vs_baseline": med / TARGET_RAYS_PER_S,
        **extra,
    }


def run_grad_workload(width, height, samples, bounces,
                      workload="inverse_step", scene_name="room_with_sphere",
                      views=("yxz",)):
    """Inverse-rendering loss + full scene gradient: jax.value_and_grad
    of the jnp pipeline with per-sample remat. A "ray" is one traced
    path of the forward (the backward re-traces each)."""
    from fourd_ray_tracing_tpu.diff import image_loss

    cfg = build_cfg(width, height, samples, bounces)
    scene = library.SCENES[scene_name]()
    camera = default_camera(views)
    target = jnp.zeros(_image_shape(views, cfg), jnp.float32)
    vg = jax.jit(lambda s, seed: jax.value_and_grad(image_loss)(
        s, camera, cfg, seed, target))
    fn = lambda seed: vg(scene, seed)[0]
    rays = len(views) * width * height * samples
    assert bool(jnp.isfinite(jax.block_until_ready(fn(np.uint32(1)))))
    lo, med, hi = time_rounds(fn, rays)
    payload = _train_payload(workload, med, lo, hi, rays, scene=scene_name)
    _roofline(payload, med, grad_flops_per_ray(cfg, scene_name, views))
    emit(payload)
    return med


def run_train_scan_workload(width, height, samples, bounces, k=4):
    """``k`` full optimizer steps of the packed train loop
    (diff.make_packed_train_step) scanned inside ONE jit, scene evolving:
    the train-loop shape with no per-step host dispatch."""
    import optax

    from fourd_ray_tracing_tpu.diff import make_packed_train_step

    cfg = build_cfg(width, height, samples, bounces)
    scene0 = library.SCENES["room_with_sphere"]()
    target = jnp.zeros((height, width, 3), jnp.float32)
    step, init, _unpack = make_packed_train_step(
        cfg, optax.adam(1e-3), default_camera(), scene0
    )
    vec0, opt_state0 = init(scene0)

    @jax.jit
    def run_k(vec, opt_state, seeds):
        def body(carry, seed):
            vec, opt_state, loss = step(*carry, seed, target)
            return (vec, opt_state), loss

        _, losses = jax.lax.scan(body, (vec, opt_state), seeds)
        return losses[-1]

    fn = lambda seed: run_k(
        vec0, opt_state0,
        jnp.uint32(seed) * np.uint32(k) + jnp.arange(k, dtype=jnp.uint32))
    rays = width * height * samples * k
    assert bool(jnp.isfinite(jax.block_until_ready(fn(np.uint32(1)))))
    lo, med, hi = time_rounds(fn, rays, frames=max(1, FRAMES // 4))
    emit(_train_payload(f"train_scan{k}", med, lo, hi, rays,
                        steps_per_launch=k))
    return med


def run_train_minibatch_workload(width, height, samples, bounces, f=4):
    """One packed optimizer step whose gradient averages ``f``
    independent estimator samples (frames_per_step=f, diff.minibatch_loss)."""
    import optax

    from fourd_ray_tracing_tpu.diff import make_packed_train_step

    cfg = build_cfg(width, height, samples, bounces)
    scene0 = library.SCENES["room_with_sphere"]()
    target = jnp.zeros((height, width, 3), jnp.float32)
    step, init, _unpack = make_packed_train_step(
        cfg, optax.adam(1e-3), default_camera(), scene0, frames_per_step=f
    )
    vec0, opt_state0 = init(scene0)
    fn = lambda seed: step(vec0, opt_state0, jnp.uint32(seed), target)[2]
    rays = width * height * samples * f
    assert bool(jnp.isfinite(jax.block_until_ready(fn(np.uint32(1)))))
    lo, med, hi = time_rounds(fn, rays)
    emit(_train_payload(f"train_minibatch{f}", med, lo, hi, rays,
                        frames_per_step=f))
    return med


def run_soft_train_workload(width, height, samples, bounces):
    """Soft-silhouette loss + gradient (diff.soft_image_loss): the step
    renders the scene with and without the sphere, so a 'ray' is one
    traced path of ONE of the two renders."""
    from fourd_ray_tracing_tpu.diff import soft_image_loss

    cfg = build_cfg(width, height, samples, bounces)
    scene = library.SCENES["room_with_sphere"]()
    camera = default_camera()
    target = jnp.zeros((height, width, 3), jnp.float32)
    vg = jax.jit(jax.value_and_grad(
        lambda s, seed: soft_image_loss(s, camera, cfg, seed, target,
                                        edge_width=0.05,
                                        object_ref=("spheres", 0))))
    fn = lambda seed: vg(scene, seed)[0]
    rays = width * height * samples
    assert bool(jnp.isfinite(jax.block_until_ready(fn(np.uint32(1)))))
    lo, med, hi = time_rounds(fn, rays)
    emit(_train_payload("soft_step", med, lo, hi, rays))
    return med


def main():
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {platform!r}")
    if MODE == "single":
        cfg = build_cfg(WIDTH, HEIGHT, SAMPLES, BOUNCES)
        fn = make_renderer(SCENE, cfg)
        rays = WIDTH * HEIGHT * SAMPLES
        assert bool(jnp.isfinite(jax.block_until_ready(fn(np.uint32(1)))).all())
        lo, med, hi = time_rounds(fn, rays)
        emit({"metric": "rays_per_second", "value": med, "min": lo, "max": hi,
              "unit": "rays/s", "vs_baseline": med / TARGET_RAYS_PER_S})
        return

    grad_res = (
        int(os.environ.get("BENCH_GRAD_WIDTH", WIDTH)),
        int(os.environ.get("BENCH_GRAD_HEIGHT", HEIGHT)),
    )
    # The small scene batches 128 frames per launch, the engine's largest
    # step_frames chunk (an idle viewer accumulating); the heavy scenes 4.
    run_forward_workload(
        "sphere_plane_light_256", "sphere_plane_light", 256, 256, 1, 2,
        frames_per_launch=int(os.environ.get("BENCH_FRAMES_PER_LAUNCH", 128)))
    hfpl = int(os.environ.get("BENCH_HEAVY_FPL", 4))
    headline = run_forward_workload(
        "room_1280x720x8x4", "room_with_sphere", WIDTH, HEIGHT, SAMPLES,
        BOUNCES, frames_per_launch=hfpl)
    run_forward_workload(
        "room_fpl1", "room_with_sphere", WIDTH, HEIGHT, SAMPLES, BOUNCES)
    run_forward_workload(
        "hypercube_1280x720x8x4", "hypercube", WIDTH, HEIGHT, SAMPLES,
        BOUNCES, frames_per_launch=hfpl)
    run_forward_workload(
        "duocylinder_3view", "duocylinder", WIDTH, HEIGHT, SAMPLES, BOUNCES,
        views=cam.VIEWS_ALL, frames_per_launch=hfpl)
    run_forward_workload(
        "tiger_3view", "tiger", WIDTH, HEIGHT, SAMPLES, BOUNCES,
        views=cam.VIEWS_ALL, frames_per_launch=hfpl)
    run_grad_workload(grad_res[0], grad_res[1], SAMPLES, BOUNCES)
    run_train_scan_workload(grad_res[0], grad_res[1], SAMPLES, BOUNCES)
    run_train_minibatch_workload(grad_res[0], grad_res[1], SAMPLES, BOUNCES)
    run_grad_workload(grad_res[0], grad_res[1], SAMPLES, BOUNCES,
                      workload="inverse_step_tiger", scene_name="tiger")
    run_soft_train_workload(grad_res[0], grad_res[1], SAMPLES, BOUNCES)

    # The LAST line is the headline: room-with-sphere median.
    emit({
        "metric": "rays_per_second", "value": headline, "unit": "rays/s",
        "vs_baseline": headline / TARGET_RAYS_PER_S,
    })


if __name__ == "__main__":
    main()
