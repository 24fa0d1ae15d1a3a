"""Forward path-tracing kernel for NVIDIA GPUs (Pallas, Triton route).

The reference renders with one fragment-shader invocation per pixel
(shader.frag:513-528, launched at windows.cpp:45), the whole bounce loop
in registers. This kernel keeps that shape: one Triton program per block
of ``BLOCK`` pixels, the sample loop and the bounce loop inside the
program, every ray's state in registers. Nothing is written to device
memory between bounces or samples; the only output is the mean light,
three floats per pixel. The jnp pipeline (models/renderer.py) computes
the same image through XLA, which carries the ray state of the whole
image between its fusions.

Design:

* The kernel reuses the shared math: `precompute_bounce0` and
  `trace_rays` (models/renderer.py), the geometry ops, the RNG and the
  samplers are shape-polymorphic jnp functions that trace into the
  Triton kernel on (BLOCK,) pixel vectors. One math implementation, two
  compilation targets: jnp/XLA (oracle, autodiff) and Pallas-Triton
  (forward).
* Scene and camera enter as ONE packed float32 vector, padded to a power
  of two; the static pytree structure is closed over and each program
  reads its scalars back into the Scene/Camera pytrees. A view-batched
  camera basis comes back as per-view scalars selected per pixel.
* Pixels flatten over (view, y, x); the grid is (frames, blocks). Both
  axes write disjoint outputs, so every program is independent. A (K,)
  seed vector renders K whole frames per launch. The image tail clamps
  to the last pixel and is sliced away.
* RNG streams are keyed by absolute pixel coordinate and absolute sample
  index (rng_mode="per_sample"), so the block size and any device
  sharding leave the image unchanged (SURVEY §4.6). rng_mode="sequential"
  carries the reference's per-pixel stream across the sample loop
  (shader.frag:92), which a program does anyway for its own pixels.

The kernel is forward-only; training differentiates the jnp pipeline.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from fourd_ray_tracing_tpu.camera import Camera
from fourd_ray_tracing_tpu.models.renderer import (
    RenderConfig,
    precompute_bounce0,
    sample_stream_bits,
    trace_rays,
)
from fourd_ray_tracing_tpu.models.scene import (
    Scene,
    axis_alignment_hints,
    plane_norm_hints,
    plane_pair_hints,
)
from fourd_ray_tracing_tpu.ops import rng
from fourd_ray_tracing_tpu.ops.sky import light_to_color
from fourd_ray_tracing_tpu.ops.vec4 import Vec3, Vec4, normalize

# Pixels per program and warps per program, chosen by a sweep on an H100
# (PERF.md): one pixel per thread.
BLOCK = 128
NUM_WARPS = 4


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


def _pad_pow2(x):
    """Pad a 1-D array with zeros to a power-of-two length (Triton blocks
    must be powers of two)."""
    n = int(x.shape[0])
    return jnp.pad(x, (0, _next_pow2(n) - n))


def _pack_pytree(tree):
    """Flatten a pytree of small f32 arrays into one padded vector plus
    a ``rebuild(ref)`` that reads the scalars back inside the kernel.

    Scalar leaves rebuild as scalar loads. A leaf of shape (V,) (a
    view-batched camera basis component) rebuilds as a tuple of V
    scalars; see `_view_select`."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    leaves = [jnp.asarray(l, jnp.float32) for l in leaves]
    shapes = [l.shape for l in leaves]
    if any(len(s) > 1 for s in shapes):
        raise ValueError(f"kernel parameters must be scalars or vectors: {shapes}")
    sizes = [s[0] if s else 1 for s in shapes]
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
    packed = _pad_pow2(jnp.concatenate([l.reshape(-1) for l in leaves]))

    def rebuild(ref):
        vals = []
        for shape, size, off in zip(shapes, sizes, offsets[:-1]):
            if shape == ():
                vals.append(ref[off])
            else:
                vals.append(tuple(ref[off + k] for k in range(size)))
        return jax.tree_util.tree_unflatten(treedef, vals)

    return packed, rebuild


def _view_select(c, view, zero):
    """Per-pixel camera component: a scalar, or a tuple of per-view
    scalars selected by each pixel's view index
    (three_window_group.cpp:42-46)."""
    if not isinstance(c, tuple):
        return zero + c
    out = zero + c[0]
    for v in range(1, len(c)):
        out = jnp.where(view == v, zero + c[v], out)
    return out


def with_static_hints(cfg: RenderConfig, scene: Scene) -> RenderConfig:
    """Derive the fast fold's static hints (hyperplane zero components,
    wall pairs, axis alignment) from a CONCRETE scene. Forward-identical
    (the dropped terms are exact float32 zeros) but they zero gradients,
    so only the forward kernel uses them. Inside jit the scene is a
    tracer, nothing derives and ``cfg`` comes back unchanged."""
    if cfg.intersect != "fast":
        return cfg
    if cfg.plane_hints is None:
        hints = plane_norm_hints(scene)
        if hints is not None:
            cfg = dataclasses.replace(
                cfg, plane_hints=hints,
                plane_pairs=plane_pair_hints(scene, hints),
            )
    if cfg.axis_hints is None:
        ah = axis_alignment_hints(scene)
        if ah is not None:
            cfg = dataclasses.replace(cfg, axis_hints=ah)
    return cfg


def _kernel(params_ref, seed_ref, block0_ref, out_r, out_g, out_b, *,
            rebuild, cfg: RenderConfig, n_views: int, height: int,
            width: int, block: int):
    scene, camera = rebuild(params_ref)
    seed = seed_ref[pl.program_id(0)].astype(jnp.uint32)
    # block0: global index of this launch's first block (0 on one device,
    # device_index * blocks_local under sharding). Pixel coordinates and
    # RNG streams derive from the GLOBAL pixel index.
    blk = block0_ref[0] + pl.program_id(1)
    lin = blk * block + jax.lax.iota(jnp.int32, block)
    lin = jnp.minimum(lin, n_views * height * width - 1)
    view = lin // (height * width)
    rem = lin - view * (height * width)
    py = rem // width
    px = rem - py * width
    # Row 0 = top (shader.frag:515-516).
    scr_x = (px.astype(jnp.float32) + 0.5) / jnp.float32(width)
    scr_y = (py.astype(jnp.float32) + 0.5) / jnp.float32(height)

    zero = jnp.zeros((block,), jnp.float32)
    pick = lambda v: Vec4(*(_view_select(c, view, zero) for c in v))
    top, right = pick(camera.top), pick(camera.right)
    vec_to_mtr, focus = pick(camera.vec_to_mtr), pick(camera.focus)
    mx = (scr_x - 0.5) * camera.mtr_width
    my = (0.5 - scr_y) * camera.mtr_height
    d = normalize(vec_to_mtr + top * my + right * mx)

    pixel_bits = rng.pixel_stream_bits(scr_x, scr_y)
    counter0 = rng.init_counter(seed, pixel_bits.shape)
    # All samples share the primary ray (shader.frag:519): bounce 0's
    # intersection and shading run once per pixel.
    pre0 = precompute_bounce0(scene, focus, d, cfg)

    if cfg.rng_mode == "sequential":
        def sample_body(s, state):
            acc, counter = state
            light, counter = trace_rays(
                scene, focus, d, pixel_bits, seed, counter, cfg, pre0
            )
            return acc + light, counter

        acc, _ = jax.lax.fori_loop(
            0, cfg.samples, sample_body, (Vec3.full(0.0, like=zero), counter0)
        )
    else:
        def sample_body(s, acc):
            bits = sample_stream_bits(pixel_bits, s.astype(jnp.uint32))
            light, _ = trace_rays(
                scene, focus, d, bits, seed, counter0, cfg, pre0
            )
            return acc + light

        acc = jax.lax.fori_loop(
            0, cfg.samples, sample_body, Vec3.full(0.0, like=zero)
        )
    inv = 1.0 / jnp.float32(cfg.samples)
    out_r[...] = acc.x * inv
    out_g[...] = acc.y * inv
    out_b[...] = acc.z * inv


def _launch(packed, rebuild, seed_arr, block0, n_blocks, cfg, n_views,
            height, width, interpret, block, num_warps, vma=None):
    """One kernel launch over ``n_blocks`` pixel blocks starting at global
    block ``block0``; returns (frames, n_blocks * block, 3) light.
    ``vma``: the mesh axes the output varies over, when launched inside
    shard_map (its replication check types the kernel's outputs)."""
    n_frames = int(seed_arr.shape[0])
    kernel = functools.partial(
        _kernel, rebuild=rebuild, cfg=cfg, n_views=n_views, height=height,
        width=width, block=block,
    )
    plane = jax.ShapeDtypeStruct(
        (n_frames, n_blocks * block), jnp.float32,
        vma=None if vma is None else frozenset(vma),
    )
    spec = pl.BlockSpec((None, block), lambda f, i: (f, i))
    r, g, b = pl.pallas_call(
        kernel,
        grid=(n_frames, n_blocks),
        out_specs=[spec, spec, spec],
        out_shape=[plane, plane, plane],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="fourd_forward",
    )(packed, _pad_pow2(seed_arr), jnp.asarray(block0, jnp.int32).reshape(1))
    return jnp.stack([r, g, b], axis=-1)


def _check_platform(interpret: bool) -> None:
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the forward kernel is compiled for NVIDIA GPUs; on "
            f"{jax.default_backend()!r} pass interpret=True (Pallas "
            "interpreter) or render with models.renderer.render_light"
        )


def _prepare(camera, cfg, seed):
    if cfg.rng_mode not in ("per_sample", "sequential"):
        raise ValueError(f"unknown rng_mode: {cfg.rng_mode!r}")
    top_x = jnp.asarray(camera.top.x)
    n_views = int(top_x.shape[0]) if top_x.ndim > 0 else 1
    seed_arr = jnp.asarray(seed, jnp.uint32).astype(jnp.int32).reshape(-1)
    return n_views, seed_arr


def _to_images(flat, n_views, cfg, frame_batched):
    """(frames, padded pixels, 3) -> images, tail sliced away."""
    n_frames = flat.shape[0]
    flat = flat[:, : n_views * cfg.height * cfg.width]
    shape = (cfg.height, cfg.width, 3)
    if n_views > 1:
        shape = (n_views,) + shape
    if frame_batched:
        return flat.reshape((n_frames,) + shape)
    return flat.reshape(shape)


def render_light_pallas(
    scene: Scene, camera: Camera, cfg: RenderConfig, seed, *,
    interpret: bool = False, block: int = BLOCK, num_warps: int = NUM_WARPS,
) -> jnp.ndarray:
    """Sample-averaged light, shape (H, W, 3) or (V, H, W, 3).

    Equal to models.renderer.render_light up to float re-association and
    the ulps of transcendental functions (same math, same RNG streams,
    same sampler). ``seed`` may be a (K,) vector: K whole frames render
    in ONE launch and a leading frame axis appears on the result, each
    frame bit-identical to a scalar-seed call.

    ``interpret`` runs the kernel in the Pallas interpreter (how the CPU
    tests reach it); without it the kernel needs a GPU. ``block`` and
    ``num_warps`` exist for the block-size sweep and the test that the
    image does not depend on the block size.

    When the scene is concrete, the static hints derive here
    (`with_static_hints`).
    """
    cfg = with_static_hints(cfg, scene)
    return _render_light_jit(scene, camera, cfg, seed, interpret, block,
                             num_warps)


@functools.partial(
    jax.jit, static_argnames=("cfg", "interpret", "block", "num_warps")
)
def _render_light_jit(scene, camera, cfg, seed, interpret, block, num_warps):
    _check_platform(interpret)
    n_views, seed_arr = _prepare(camera, cfg, seed)
    packed, rebuild = _pack_pytree((scene, camera))
    n_blocks = pl.cdiv(n_views * cfg.height * cfg.width, block)
    flat = _launch(packed, rebuild, seed_arr, 0, n_blocks, cfg, n_views,
                   cfg.height, cfg.width, interpret, block, num_warps)
    return _to_images(flat, n_views, cfg, jnp.ndim(seed) >= 1)


def sharded_render_light_pallas(
    scene: Scene, camera: Camera, cfg: RenderConfig, seed, mesh, *,
    interpret: bool = False,
) -> jnp.ndarray:
    """`render_light_pallas` with the BLOCK axis sharded over every
    device of ``mesh``: each device launches the kernel on its contiguous
    range of pixel blocks (block0 = device_index * blocks_local). Pixel
    coordinates and RNG streams derive from the global block index, so
    the image is bit-identical to the one-device kernel for any mesh
    shape. The block count pads up to a device multiple; padding blocks
    render clamped pixels that the tail slice discards."""
    cfg = with_static_hints(cfg, scene)
    return _sharded_render_light_jit(scene, camera, cfg, seed, mesh, interpret)


@functools.partial(jax.jit, static_argnames=("cfg", "mesh", "interpret"))
def _sharded_render_light_jit(scene, camera, cfg, seed, mesh, interpret):
    from jax.sharding import PartitionSpec as P

    _check_platform(interpret)
    n_views, seed_arr = _prepare(camera, cfg, seed)
    packed, rebuild = _pack_pytree((scene, camera))
    axes = tuple(mesh.axis_names)
    n_dev = int(np.prod([mesh.shape[a] for a in axes]))
    n_blocks = pl.cdiv(n_views * cfg.height * cfg.width, BLOCK)
    blocks_local = pl.cdiv(n_blocks, n_dev)

    def local(packed, seed_arr):
        # Linear device index over the whole mesh = global block offset.
        idx = jax.lax.axis_index(axes[0])
        for a in axes[1:]:
            idx = idx * mesh.shape[a] + jax.lax.axis_index(a)
        # Every operand varies over the mesh like block0 does.
        packed, seed_arr = jax.lax.pcast((packed, seed_arr), axes, to="varying")
        return _launch(packed, rebuild, seed_arr, idx * blocks_local,
                       blocks_local, cfg, n_views, cfg.height, cfg.width,
                       interpret, BLOCK, NUM_WARPS, vma=axes)

    # The compiled kernel passes shard_map's replication check. The Pallas
    # interpreter (jax 0.9.0, pallas/hlo_interpreter.py) does not: it
    # slices the kernel's refs with grid indices that do not vary over
    # the mesh, so interpreted runs switch the check off.
    flat = jax.shard_map(
        local, mesh=mesh, in_specs=(P(), P()), out_specs=P(None, axes),
        check_vma=not interpret,
    )(packed, seed_arr)
    return _to_images(flat, n_views, cfg, jnp.ndim(seed) >= 1)


def _tonemap(light, cfg: RenderConfig):
    color = light_to_color(
        Vec3(light[..., 0], light[..., 1], light[..., 2]),
        jnp.float32(cfg.light_coefficient),
    )
    return color.stack(axis=-1)


def render_image_pallas(scene: Scene, camera: Camera, cfg: RenderConfig,
                        seed, *, interpret: bool = False) -> jnp.ndarray:
    """Tone-mapped image via the kernel (shader.frag:522-527). A (K,)
    ``seed`` vector renders K frames in one launch."""
    light = render_light_pallas(scene, camera, cfg, seed, interpret=interpret)
    return _tonemap(light, cfg)


def sharded_render_image_pallas(scene: Scene, camera: Camera,
                                cfg: RenderConfig, seed, mesh, *,
                                interpret: bool = False) -> jnp.ndarray:
    """Tone-mapped mesh-sharded kernel render
    (see sharded_render_light_pallas)."""
    light = sharded_render_light_pallas(scene, camera, cfg, seed, mesh,
                                        interpret=interpret)
    return _tonemap(light, cfg)


# Engine capability flag: a (K,) seed vector batches K frames per launch.
render_light_pallas.supports_seed_batch = True
render_image_pallas.supports_seed_batch = True
