"""Training steps on jax.value_and_grad of the jnp pipeline.

The minibatch loss (F estimator samples per step), the packed-space
step (adam on one flat parameter vector) and the mesh-sharded step all
differentiate the same estimator at fixed RNG (diff.py semantics), so
their losses and gradients must agree with the plain one-device pytree
step up to float re-association.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

from fourd_ray_tracing_tpu import camera as cam
from fourd_ray_tracing_tpu.diff import (
    frame_seeds,
    image_loss,
    make_packed_train_step,
    make_train_step,
    minibatch_loss,
)
from fourd_ray_tracing_tpu.models import library
from fourd_ray_tracing_tpu.models.renderer import RenderConfig
from fourd_ray_tracing_tpu.ops.vec4 import Vec4

CFG = RenderConfig(
    width=16, height=8, samples=2, reflections_amount=1,
    rng_mode="per_sample", light_coefficient=0.7,
)


def default_camera():
    return cam.camera_from_state(
        Vec4.of(0.0, -2.0, 0.0, 0.0),
        cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)),
        1.5,
        2.0,
    )


def _flat(tree):
    leaves = jax.tree_util.tree_leaves(tree)
    return np.concatenate([np.asarray(l, np.float32).reshape(-1) for l in leaves])


def _target(seed):
    return jnp.asarray(
        np.random.default_rng(seed).uniform(0, 1, (CFG.height, CFG.width, 3)),
        jnp.float32,
    )


def test_camera_grads_flow():
    """Camera parameters (focus, basis) get gradients too."""
    scene = library.sphere_plane_light()
    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)
    g_cam = jax.jit(jax.grad(lambda c: image_loss(scene, c, CFG, 3, target)))(
        default_camera()
    )
    assert np.abs(_flat(g_cam)).max() > 1e-8


def test_minibatch_grads_match_mean_of_singles():
    """minibatch_loss over F frames: loss and every gradient equal the
    MEAN of the F scalar-seed losses at `frame_seeds`, up to float
    re-association."""
    scene = library.room_with_sphere()
    camera = default_camera()
    target = _target(2)

    def single(s, seed, t):
        return image_loss(s, camera, CFG, seed, t)

    seeds = np.asarray(frame_seeds(np.uint32(5), 3))
    np.testing.assert_array_equal(seeds, [15, 16, 17])
    vg = jax.jit(jax.value_and_grad(single))
    singles = [vg(scene, s, target) for s in seeds]
    lb, gb = jax.jit(jax.value_and_grad(minibatch_loss(single, 3)))(
        scene, np.uint32(5), target
    )
    mean_loss = sum(float(l) for l, _ in singles) / 3
    np.testing.assert_allclose(float(lb), mean_loss, rtol=1e-5)
    mean_g = sum(_flat(g) for _, g in singles) / 3
    np.testing.assert_allclose(
        _flat(gb), mean_g, rtol=1e-4,
        atol=1e-6 * max(1.0, float(np.abs(mean_g).max())),
    )


def test_minibatch_train_steps_reduce_loss():
    """make_train_step / make_packed_train_step with frames_per_step=4:
    the minibatch step runs, agrees between the pytree and packed forms,
    and reduces the loss on a short fit."""
    scene = library.room_with_sphere()
    camera = default_camera()
    target = jnp.zeros((CFG.height, CFG.width, 3), jnp.float32)
    opt = optax.adam(1e-2)

    step = make_train_step(CFG, opt, camera, frames_per_step=4)
    pstep, pinit, _unpack = make_packed_train_step(
        CFG, opt, camera, scene, frames_per_step=4
    )

    s1, o1, loss1, _m = step(scene, opt.init(scene), np.uint32(3), target)
    vec, ostate = pinit(scene)
    vec2, ostate2, loss2 = pstep(vec, ostate, np.uint32(3), target)
    # Same seeds, same estimator, same adam: packed == pytree.
    np.testing.assert_allclose(float(loss2), float(loss1), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(vec2), _flat(s1), rtol=1e-5,
                               atol=1e-7)

    losses = [float(loss2)]
    for k in range(4, 8):
        vec2, ostate2, l = pstep(vec2, ostate2, np.uint32(k), target)
        losses.append(float(l))
    assert losses[-1] < losses[0], losses


def test_packed_train_step_matches_pytree():
    """The packed-space step (diff.make_packed_train_step) follows the
    pytree step: same estimator, same per-element gradient (the
    transpose of unpack's slices), and adam's elementwise math; 3 steps.
    ``unpack`` restores the pytree."""
    scene0 = library.room_with_sphere()
    camera = default_camera()
    target = _target(6)
    opt = optax.adam(1e-2)

    step_t = make_train_step(CFG, opt, camera)
    step_p, init_p, unpack = make_packed_train_step(CFG, opt, camera, scene0)

    scene_t, ostate_t = scene0, opt.init(scene0)
    vec_p, ostate_p = init_p(scene0)
    for i in range(3):
        scene_t, ostate_t, loss_t, _ = step_t(
            scene_t, ostate_t, np.uint32(11 + i), target
        )
        vec_p, ostate_p, loss_p = step_p(
            vec_p, ostate_p, np.uint32(11 + i), target
        )
        np.testing.assert_allclose(float(loss_p), float(loss_t), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(vec_p), _flat(scene_t), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_array_equal(_flat(unpack(vec_p)), np.asarray(vec_p))
    assert (jax.tree_util.tree_structure(unpack(vec_p))
            == jax.tree_util.tree_structure(scene0))


def test_packed_param_filter_freezes_leaves():
    """param_filter becomes a packed 0/1 gradient mask: frozen leaves
    never move, the kept one does."""
    scene0 = library.sphere_plane_light()
    camera = default_camera()
    target = _target(3)

    def only_sphere_glow(g):
        z = jax.tree.map(jnp.zeros_like, g)
        mat = z.spheres[0].material._replace(glow=g.spheres[0].material.glow)
        return z._replace(spheres=(z.spheres[0]._replace(material=mat),)
                          + z.spheres[1:])

    opt = optax.adam(1e-1)
    step, init, unpack = make_packed_train_step(
        CFG, opt, camera, scene0, param_filter=only_sphere_glow
    )
    vec, ost = init(scene0)
    vec, ost, _ = step(vec, ost, np.uint32(1), target)
    moved = np.asarray(vec) != _flat(scene0)
    glow_mask = _flat(only_sphere_glow(
        jax.tree.map(jnp.ones_like, scene0))) != 0
    assert moved[glow_mask].all() and not moved[~glow_mask].any()
    assert float(unpack(vec).spheres[0].material.glow) != float(
        scene0.spheres[0].material.glow)


@pytest.mark.slow
def test_train_step_mesh_matches_single_device():
    """make_train_step(mesh=...) shards rays/samples over the CPU mesh:
    one step's loss, gradient norm and updated scene equal the
    one-device step up to psum re-association."""
    from fourd_ray_tracing_tpu.parallel.mesh import make_mesh

    scene = library.room_with_sphere()
    camera = default_camera()
    target = _target(4)
    opt = optax.adam(1e-2)
    mesh = make_mesh(rays=4, samples=2)

    step_1 = make_train_step(CFG, opt, camera)
    step_n = make_train_step(CFG, opt, camera, mesh=mesh)
    s1, _, loss1, m1 = step_1(scene, opt.init(scene), np.uint32(5), target)
    sn, _, lossn, mn = step_n(scene, opt.init(scene), np.uint32(5), target)
    np.testing.assert_allclose(float(lossn), float(loss1), rtol=1e-5)
    np.testing.assert_allclose(
        float(mn["grad_norm"]), float(m1["grad_norm"]), rtol=1e-4
    )
    np.testing.assert_allclose(_flat(sn), _flat(s1), rtol=1e-4, atol=1e-7)


@pytest.mark.slow
def test_minibatch_mesh_matches_single_device():
    """frames_per_step composes with the mesh: the sharded minibatch
    step equals the one-device minibatch step."""
    from fourd_ray_tracing_tpu.parallel.mesh import make_mesh

    scene = library.room_with_sphere()
    camera = default_camera()
    target = _target(8)
    opt = optax.adam(1e-2)
    mesh = make_mesh(rays=4, samples=2)
    step_1 = make_train_step(CFG, opt, camera, frames_per_step=2)
    step_n = make_train_step(CFG, opt, camera, mesh=mesh, frames_per_step=2)
    s1, _, l1, _ = step_1(scene, opt.init(scene), np.uint32(5), target)
    sn, _, ln, _ = step_n(scene, opt.init(scene), np.uint32(5), target)
    np.testing.assert_allclose(float(ln), float(l1), rtol=1e-5)
    np.testing.assert_allclose(_flat(sn), _flat(s1), rtol=1e-4, atol=1e-7)
