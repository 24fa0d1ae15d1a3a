"""Sharding tests on the 8-virtual-device CPU mesh (SURVEY §4.5-4.6)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fourd_ray_tracing_tpu import camera as cam
from fourd_ray_tracing_tpu.models import library
from fourd_ray_tracing_tpu.models.renderer import (
    RenderConfig,
    render_image,
    render_light,
)
from fourd_ray_tracing_tpu.parallel import mesh as pmesh
from fourd_ray_tracing_tpu.ops.vec4 import Vec4

CFG = RenderConfig(
    width=32, height=16, samples=4, reflections_amount=2, rng_mode="per_sample"
)


def default_camera():
    return cam.camera_from_state(
        Vec4.of(0.0, -2.0, 0.0, 0.0),
        cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)),
        1.5,
        2.0,
    )


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 4)])
@pytest.mark.slow
def test_sharded_image_bitwise_equals_single_device(shape):
    """Determinism across ANY mesh factorization (SURVEY §4.6).

    The (1, 4) case runs on a 4-device submesh — device COUNT must not
    change the image either."""
    scene = library.sphere_plane_light()
    camera = default_camera()
    single = np.asarray(render_image(scene, camera, CFG, seed=77))
    devices = jax.devices()[: shape[0] * shape[1]]
    m = pmesh.make_mesh(rays=shape[0], samples=shape[1], devices=devices)
    sharded = np.asarray(pmesh.sharded_render_image(scene, camera, CFG, 77, m))
    assert sharded.shape == single.shape
    # pixels identical; sample-axis psum may reassociate the (tiny) sum,
    # so allow 1-ulp-scale slack rather than bitwise when samples split.
    if shape[1] == 1:
        np.testing.assert_array_equal(sharded, single)
    else:
        np.testing.assert_allclose(sharded, single, atol=2e-6)


@pytest.mark.parametrize("shape", [(8, 1), (2, 2)])
@pytest.mark.slow
def test_sharded_megakernel_matches_single_device(shape):
    """The forward kernel sharded over the mesh (block0 scheme):
    bit-identical to the single-device kernel for mesh shapes that do
    and don't divide the block count, scalar and frame-batched seeds."""
    from fourd_ray_tracing_tpu.ops.pallas.megakernel import (
        render_image_pallas,
        sharded_render_image_pallas,
    )

    scene = library.room_with_sphere()
    camera = default_camera()
    single = np.asarray(render_image_pallas(scene, camera, CFG, np.uint32(77),
                                            interpret=True))
    devices = jax.devices()[: shape[0] * shape[1]]
    m = pmesh.make_mesh(rays=shape[0], samples=shape[1], devices=devices)
    sharded = np.asarray(
        sharded_render_image_pallas(scene, camera, CFG, np.uint32(77), m,
                                    interpret=True)
    )
    np.testing.assert_array_equal(sharded, single)
    # Frame-batched seeds shard identically.
    seeds = jnp.arange(2, dtype=jnp.uint32) + 5
    single_b = np.asarray(render_image_pallas(scene, camera, CFG, seeds,
                                              interpret=True))
    sharded_b = np.asarray(
        sharded_render_image_pallas(scene, camera, CFG, seeds, m,
                                    interpret=True)
    )
    np.testing.assert_array_equal(sharded_b, single_b)


def test_sequential_mode_rejects_sample_sharding():
    scene = library.tiger()
    cfg = RenderConfig(width=32, height=16, samples=4, rng_mode="sequential")
    m = pmesh.make_mesh(rays=4, samples=2)
    with pytest.raises(ValueError):
        pmesh.sharded_render_light(scene, default_camera(), cfg, 1, m)


@pytest.mark.slow
def test_sharded_grads_equal_single_device():
    """psum'd scene grads == single-device grads (SURVEY §4.5)."""
    scene = library.sphere_plane_light()
    camera = default_camera()
    cfg = RenderConfig(
        width=16, height=8, samples=2, reflections_amount=1, rng_mode="per_sample"
    )
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    def loss_single(scene):
        img = render_image(scene, camera, cfg, 5)
        return jnp.mean((img - target) ** 2)

    m = pmesh.make_mesh(rays=4, samples=2)

    def loss_sharded(scene):
        img = pmesh.sharded_render_image(scene, camera, cfg, 5, m)
        return jnp.mean((img - target) ** 2)

    g1 = jax.grad(loss_single)(scene)
    g2 = jax.grad(loss_sharded)(scene)
    flat1 = jax.tree.leaves(g1)
    flat2 = jax.tree.leaves(g2)
    assert len(flat1) == len(flat2)
    for a, b in zip(flat1, flat2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-7)


@pytest.mark.slow
def test_view_batched_sharded_render():
    scene = library.duocylinder()
    angles = cam.CameraAngles(jnp.float32(0.1), jnp.float32(0.0), jnp.float32(0.2))
    orient = cam.orientation_from_angles(angles.fi, angles.te, angles.psi)
    tops, rights = cam.batched_view_bases(orient)
    camera = cam.Camera(
        focus=Vec4.of(0, -2, 0, 0),
        vec_to_mtr=orient.forward * jnp.float32(1.5),
        top=tops,
        right=rights,
        mtr_width=jnp.float32(2.0 * cam.GOLDEN),
        mtr_height=jnp.float32(2.0),
    )
    m = pmesh.make_mesh(rays=4, samples=2)
    img = np.asarray(pmesh.sharded_render_image(scene, camera, CFG, 3, m))
    assert img.shape == (3, CFG.height, CFG.width, 3)
    single = np.asarray(render_image(scene, camera, CFG, 3))
    np.testing.assert_allclose(img, single, atol=2e-6)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_jit_sharded_renderer_matches_single_device(impl):
    """parallel.mesh.jit_sharded_renderer on a 2x2 mesh, both impls,
    against the one-device render of the same seed: the kernel's block
    axis shards bit-identically (shard_map with its replication check
    on); the jnp pipeline's sample psum may re-associate the sum."""
    from fourd_ray_tracing_tpu.ops.pallas.megakernel import render_image_pallas

    cfg = RenderConfig(width=16, height=8, samples=2, reflections_amount=1,
                       rng_mode="per_sample")
    scene = library.sphere_plane_light()
    camera = default_camera()
    m = pmesh.make_mesh(rays=2, samples=2, devices=jax.devices()[:4])
    run = pmesh.jit_sharded_renderer(cfg, m, impl=impl, interpret=True)
    got = np.asarray(run(scene, camera, np.uint32(9)))
    if impl == "pallas":
        single = jax.jit(lambda s, c, seed: render_image_pallas(
            s, c, cfg, seed, interpret=True))
        want = np.asarray(single(scene, camera, np.uint32(9)))
        np.testing.assert_array_equal(got, want)
    else:
        want = np.asarray(jax.jit(lambda s: render_image(scene, camera, cfg, s))(
            np.uint32(9)))
        np.testing.assert_allclose(got, want, atol=2e-6)
