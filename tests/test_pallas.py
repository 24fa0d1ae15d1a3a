"""Forward kernel (Pallas, Triton route) vs the jnp renderer.

On the CPU the kernel runs in the Pallas interpreter (explicit
``interpret=True``): the same kernel body, block indexing, padding and
RNG keying as on the card, so any block/index/RNG-stream bug shows up as
a pixel mismatch. What the interpreter cannot show (Triton's own
lowering and the card's arithmetic) the ``gpu``-marked test checks on a
card.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from helpers import assert_images_close

from fourd_ray_tracing_tpu import camera as cam
from fourd_ray_tracing_tpu.engine import resolve_impl
from fourd_ray_tracing_tpu.models import library
from fourd_ray_tracing_tpu.models.renderer import RenderConfig, render_light
from fourd_ray_tracing_tpu.ops.pallas import megakernel as mk
from fourd_ray_tracing_tpu.ops.pallas.megakernel import (
    render_image_pallas,
    render_light_pallas,
)
from fourd_ray_tracing_tpu.ops.vec4 import Vec4

CFG = RenderConfig(
    width=32, height=16, samples=2, reflections_amount=2, rng_mode="per_sample"
)


def default_camera():
    return cam.camera_from_state(
        Vec4.of(0.0, -2.0, 0.0, 0.0),
        cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)),
        1.5,
        2.0,
    )


def three_view_camera():
    angles = cam.CameraAngles(jnp.float32(0.1), jnp.float32(0.0), jnp.float32(0.2))
    orient = cam.orientation_from_angles(angles.fi, angles.te, angles.psi)
    tops, rights = cam.batched_view_bases(orient)
    return cam.Camera(
        focus=Vec4.of(0, -2, 0, 0),
        vec_to_mtr=orient.forward * jnp.float32(1.5),
        top=tops,
        right=rights,
        mtr_width=jnp.float32(2.0 * cam.GOLDEN),
        mtr_height=jnp.float32(2.0),
    )


@pytest.mark.parametrize("scene_name", sorted(library.SCENES))
def test_megakernel_matches_jnp_renderer(scene_name):
    """Every canonical scene through the kernel vs the jnp renderer —
    tiger/duocylinder/hypercube exercise the composite-primitive paths."""
    scene = library.SCENES[scene_name]()
    camera = default_camera()
    ref = np.asarray(render_light(scene, camera, CFG, 7))
    out = np.asarray(render_light_pallas(scene, camera, CFG, 7, interpret=True))
    assert out.shape == ref.shape
    assert_images_close(out, ref, atol=1e-5, boundary_frac=0.02,
                        mean_atol=0.05)


@pytest.mark.parametrize("scene_name", sorted(library.SCENES))
def test_block_size_does_not_change_image(scene_name):
    """Pixel coordinates and RNG streams derive from the absolute pixel
    index, so the program block size must not change a single bit."""
    scene = library.SCENES[scene_name]()
    camera = default_camera()
    a = np.asarray(render_light_pallas(scene, camera, CFG, 5, interpret=True))
    b = np.asarray(render_light_pallas(scene, camera, CFG, 5, interpret=True,
                                       block=64))
    np.testing.assert_array_equal(a, b)


def test_megakernel_sequential_rng_matches_jnp():
    """rng_mode="sequential" — the reference's per-pixel stream carried
    across the sample loop (shader.frag:92) — through the kernel: it
    pays the dead final-iteration draws exactly like
    renderer.trace_rays (the same function) so the NEXT sample's stream
    matches."""
    cfg = RenderConfig(
        width=32, height=16, samples=3, reflections_amount=2,
        rng_mode="sequential",
    )
    scene = library.sphere_plane_light()
    camera = default_camera()
    ref = np.asarray(render_light(scene, camera, cfg, 13))
    out = np.asarray(render_light_pallas(scene, camera, cfg, 13, interpret=True))
    assert_images_close(out, ref, atol=1e-5, boundary_frac=0.02,
                        mean_atol=0.05)


def test_megakernel_sequential_rng_zero_bounce():
    """reflections_amount=0 exercises the pre0 shade-only branch's
    sequential dead draws (they shift sample 2+'s stream)."""
    cfg = RenderConfig(
        width=32, height=16, samples=3, reflections_amount=0,
        rng_mode="sequential",
    )
    scene = library.sphere_plane_light()
    camera = default_camera()
    ref = np.asarray(render_light(scene, camera, cfg, 7))
    out = np.asarray(render_light_pallas(scene, camera, cfg, 7, interpret=True))
    assert_images_close(out, ref, atol=1e-5, boundary_frac=0.02,
                        mean_atol=0.05)


def test_megakernel_view_batched():
    """One launch renders all three orthogonal sections (the batched
    replacement for three sequential draws, three_window_group.cpp:42-46):
    the per-view basis comes back as per-view scalars selected per
    pixel."""
    scene = library.sphere_plane_light()
    camera = three_view_camera()
    ref = np.asarray(render_light(scene, camera, CFG, 3))
    out = np.asarray(render_light_pallas(scene, camera, CFG, 3, interpret=True))
    assert out.shape == (3, CFG.height, CFG.width, 3)
    assert_images_close(out, ref, atol=1e-5, boundary_frac=0.02)


@pytest.mark.parametrize("views", [1, 3])
def test_padding_and_untiling_off_block_multiple(views):
    """Pixel counts that are not a multiple of the block (13x7 = 91 and
    3 x 91 = 273 pixels at block 64): the tail clamps to the last pixel
    inside the kernel and the wrapper slices it away, restoring the
    (V, H, W, 3) layout."""
    cfg = RenderConfig(width=13, height=7, samples=2, reflections_amount=1,
                       rng_mode="per_sample")
    camera = default_camera() if views == 1 else three_view_camera()
    scene = library.sphere_plane_light()
    # Jitted reference: at 13 columns op-by-op dispatch rounds some
    # screen coordinates differently from a compiled program.
    ref = np.asarray(jax.jit(lambda s: render_light(scene, camera, cfg, s))(21))
    out = np.asarray(render_light_pallas(scene, camera, cfg, 21,
                                         interpret=True, block=64))
    assert out.shape == ref.shape
    assert_images_close(out, ref, atol=1e-5, boundary_frac=0.02)


def test_megakernel_tonemapped_range():
    img = np.asarray(
        render_image_pallas(library.tiger(), default_camera(), CFG, 9,
                            interpret=True)
    )
    assert (img >= 0).all() and (img <= 1).all()


def test_megakernel_frame_batch_bitwise():
    """A (K,) seed vector (grid frame axis, one launch) must be
    BIT-identical per frame to K scalar-seed calls (interactive-scale
    frames batch into one launch)."""
    scene = library.sphere_plane_light()
    camera = default_camera()
    seeds = np.asarray([3, 9, 3], np.uint32)
    batch = np.asarray(render_light_pallas(scene, camera, CFG, seeds,
                                           interpret=True))
    assert batch.shape == (3, CFG.height, CFG.width, 3)
    for k, s in enumerate(seeds):
        single = np.asarray(render_light_pallas(scene, camera, CFG, s,
                                                interpret=True))
        np.testing.assert_array_equal(batch[k], single)


def test_pack_pytree_pads_to_power_of_two_and_keeps_views_scalar():
    """The packed parameter vector pads to a power of two (Triton blocks
    must be powers of two) and a (V,) camera leaf rebuilds as V scalars,
    never as a length-3 vector."""
    camera = three_view_camera()
    scene = library.room_with_sphere()
    packed, rebuild = mk._pack_pytree((scene, camera))
    n = len(jax.tree_util.tree_leaves(scene)) + sum(
        int(np.size(l)) for l in jax.tree_util.tree_leaves(camera)
    )
    size = int(packed.shape[0])
    assert size >= n and size & (size - 1) == 0 and size < 2 * n
    np.testing.assert_array_equal(np.asarray(packed[n:]), 0.0)
    scene_r, camera_r = rebuild(np.asarray(packed))
    assert isinstance(camera_r.top.x, tuple) and len(camera_r.top.x) == 3
    np.testing.assert_array_equal(np.asarray(camera_r.top.x),
                                  np.asarray(camera.top.x))
    assert float(scene_r.spheres[0].r) == float(scene.spheres[0].r)


def test_kernel_refuses_to_interpret_on_its_own():
    """Off the GPU the kernel never drops into interpret mode by itself:
    without ``interpret=True`` the entry point raises."""
    with pytest.raises(ValueError, match="interpret=True"):
        render_light_pallas(library.sphere_plane_light(), default_camera(),
                            CFG, 1)


@pytest.mark.parametrize(
    "platform,impl,want",
    [("gpu", "auto", "pallas"), ("cpu", "auto", "xla"),
     ("gpu", "xla", "xla"), ("cpu", "pallas", "pallas")],
)
def test_resolve_impl_per_platform(platform, impl, want):
    assert resolve_impl(impl, platform) == want


@pytest.mark.parametrize("platform,impl", [("metal", "auto"), ("rocm", "auto"),
                                           ("gpu", "mosaic")])
def test_resolve_impl_rejects_unknown(platform, impl):
    with pytest.raises(ValueError):
        resolve_impl(impl, platform)


def test_engine_kernel_path_matches_xla_path():
    """RenderEngine(impl="pallas") — the GPU production path, here in the
    interpreter — accumulates the same frames as impl="xla"."""
    from fourd_ray_tracing_tpu.engine import RenderEngine

    kw = dict(focus=Vec4.of(0.0, -2.0, 0.0, 0.0),
              angles=cam.CameraAngles(jnp.float32(0), jnp.float32(0),
                                      jnp.float32(0)),
              deterministic=True, use_native_controls="python")
    cfg = RenderConfig(width=16, height=8, samples=2, reflections_amount=1,
                       rng_mode="per_sample")
    scene = library.room_with_sphere()
    k = RenderEngine(scene, cfg, impl="pallas", interpret=True, **kw)
    x = RenderEngine(scene, cfg, impl="xla", **kw)
    assert k.impl == "pallas" and x.impl == "xla"
    assert_images_close(np.asarray(k.step_frames(3)),
                        np.asarray(x.step_frames(3)), atol=1e-5,
                        boundary_frac=0.02)


@pytest.mark.gpu
def test_megakernel_bitwise_on_gpu():
    """On the card the kernel must be BITWISE-identical to itself across
    launches and block sizes (same compilation => deterministic; RNG
    keyed by absolute pixel/sample id => block-invariant), and agree
    with the jnp pipeline compiled by XLA up to boundary flips."""
    scene = library.room_with_sphere()
    camera = default_camera()
    cfg = RenderConfig(width=1280, height=720, samples=4,
                       reflections_amount=4, rng_mode="per_sample")
    a = np.asarray(render_light_pallas(scene, camera, cfg, 7))
    b = np.asarray(render_light_pallas(scene, camera, cfg, 7))
    np.testing.assert_array_equal(a, b)
    c = np.asarray(render_light_pallas(scene, camera, cfg, 7, block=256,
                                       num_warps=8))
    np.testing.assert_array_equal(a, c)
    ref = np.asarray(jax.jit(lambda s: render_light(scene, camera, cfg, s))(7))
    assert_images_close(a, ref, atol=1e-4, boundary_frac=0.01,
                        mean_atol=1e-4)

