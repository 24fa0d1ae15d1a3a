"""Device-mesh sharding of the renderer (SURVEY §2.4 build targets).

The parallel axes of a path tracer (the transformer DP/SP analogues):

* ``rays``  — image rows shard across devices (embarrassingly parallel,
  no communication in the forward pass);
* ``samples`` — samples-per-pixel shard across devices; the per-pixel
  mean is a `psum` over this axis (the only forward collective).

Scene parameters and camera are replicated. Gradients w.r.t. the scene
flow back through `shard_map`: the psum/replication duality means XLA
inserts the gradient all-reduce automatically, overlapped with the rest
of the backward (SURVEY §7). On GPUs XLA hands the collectives to NCCL,
over NVLink between the cards of one host. Every card reaches every
other at the same rate, so the mesh is a plain (rays, samples) grid over
`jax.devices()` with no topology.

Multi-host: `initialize_distributed` wraps jax.distributed.initialize;
the same mesh code then spans all hosts' devices (NCCL between the
processes). Everything here is testable on a CPU mesh via
``--xla_force_host_platform_device_count=8`` (tests/test_sharding.py).

Determinism: the RNG streams are keyed by absolute pixel coordinate and
absolute sample index (rng_mode="per_sample"), so the rendered image is
bit-identical for ANY device count — mirroring how the reference keys
its RNG by scr_coord (shader.frag:106-107), per SURVEY §4.6.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from fourd_ray_tracing_tpu.camera import Camera
from fourd_ray_tracing_tpu.models.renderer import (
    RenderConfig,
    render_light_tile,
)
from fourd_ray_tracing_tpu.models.scene import Scene
from fourd_ray_tracing_tpu.ops.sky import light_to_color
from fourd_ray_tracing_tpu.ops.vec4 import Vec3

RAYS_AXIS = "rays"
SAMPLES_AXIS = "samples"


def initialize_distributed(**kwargs) -> None:
    """Multi-process init (jax.distributed.initialize), a no-op unless
    JAX_COORDINATOR_ADDRESS is set or arguments are given (the
    coordinator address, process count and process id)."""
    import os

    if os.environ.get("JAX_COORDINATOR_ADDRESS") or kwargs:
        jax.distributed.initialize(**kwargs)


def make_mesh(
    rays: Optional[int] = None,
    samples: int = 1,
    devices=None,
) -> Mesh:
    """Build a (rays, samples) mesh over all devices by default."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if rays is None:
        rays = n // samples
    if rays * samples != n:
        raise ValueError(f"mesh {rays}x{samples} != {n} devices")
    return Mesh(devices.reshape(rays, samples), (RAYS_AXIS, SAMPLES_AXIS))


def _validate(cfg: RenderConfig, n_rays: int, n_samples: int) -> None:
    if cfg.height % n_rays != 0:
        raise ValueError(f"height {cfg.height} not divisible by rays axis {n_rays}")
    if cfg.samples % n_samples != 0:
        raise ValueError(
            f"samples {cfg.samples} not divisible by samples axis {n_samples}"
        )
    if n_samples > 1 and cfg.rng_mode != "per_sample":
        raise ValueError(
            'sharding the sample axis requires rng_mode="per_sample" '
            "(sequential streams cannot start mid-stream)"
        )


def sharded_render_light(
    scene: Scene, camera: Camera, cfg: RenderConfig, seed, mesh: Mesh
) -> jnp.ndarray:
    """Render the full image over the mesh; returns replicated-over-samples,
    row-sharded global light (..., H, W, 3), already sample-averaged."""
    n_rays = mesh.shape[RAYS_AXIS]
    n_samples = mesh.shape[SAMPLES_AXIS]
    _validate(cfg, n_rays, n_samples)
    rows_local = cfg.height // n_rays
    samples_local = cfg.samples // n_samples

    axes = (RAYS_AXIS, SAMPLES_AXIS)

    def local(scene, camera, seed):
        r = jax.lax.axis_index(RAYS_AXIS)
        s = jax.lax.axis_index(SAMPLES_AXIS)
        acc = render_light_tile(
            scene,
            camera,
            cfg,
            seed,
            row0=r * rows_local,
            n_rows=rows_local,
            sample0=s * samples_local,
            n_samples=samples_local,
            # Explicitly cast the loop-carried accumulator to
            # device-varying so shard_map's replication checker types the
            # sample fori_loop (the carry starts as a replicated zero).
            vary_axes=axes,
        )
        # The single forward collective: per-pixel sample sum.
        total = jax.lax.psum(acc, SAMPLES_AXIS)
        return total * (1.0 / jnp.float32(cfg.samples))

    view_batched = jnp.asarray(camera.top.x).ndim > 0
    out_spec = P(None, RAYS_AXIS) if view_batched else P(RAYS_AXIS)
    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(), P(), P()),   # scene/camera/seed replicated
        out_specs=out_spec,         # rows sharded, samples-replicated
    )(scene, camera, jnp.asarray(seed, jnp.uint32))


def sharded_render_image(
    scene: Scene, camera: Camera, cfg: RenderConfig, seed, mesh: Mesh
) -> jnp.ndarray:
    light = sharded_render_light(scene, camera, cfg, seed, mesh)
    color = light_to_color(
        Vec3(light[..., 0], light[..., 1], light[..., 2]),
        jnp.float32(cfg.light_coefficient),
    )
    return color.stack(axis=-1)


def jit_sharded_renderer(cfg: RenderConfig, mesh: Mesh, tonemap: bool = True,
                         impl: str = "auto", interpret: bool = False):
    """jit-compiled sharded renderer: (scene, camera, seed) -> image.

    ``impl`` as in `engine.resolve_impl`: "pallas" routes through the
    mesh-sharded forward kernel (megakernel.sharded_render_{light,image}_
    pallas — its block axis shards over every device, bit-identical to
    one device); "xla" through the jnp pipeline sharded over (rays,
    samples), which is also the autodiff path. ``interpret`` runs the
    kernel in the Pallas interpreter (CPU tests).
    """
    from fourd_ray_tracing_tpu.engine import resolve_impl

    if resolve_impl(impl) == "pallas":
        from fourd_ray_tracing_tpu.ops.pallas.megakernel import (
            sharded_render_image_pallas,
            sharded_render_light_pallas,
        )

        kfn = sharded_render_image_pallas if tonemap else sharded_render_light_pallas

        @jax.jit
        def run_kernel(scene, camera, seed):
            return kfn(scene, camera, cfg, seed, mesh, interpret=interpret)

        return run_kernel
    fn = sharded_render_image if tonemap else sharded_render_light

    @jax.jit
    def run(scene, camera, seed):
        return fn(scene, camera, cfg, seed, mesh)

    return run
