"""Soft-silhouette boundary gradients (diff.soft_image_loss).

The plain fixed-outcome estimator is boundary-blind: a flat emissive
sphere on a dark background has EXACTLY zero position gradient (its only
effect on the image is which pixels it covers). The soft mode renders
with/without the sphere and alpha-blends by a differentiable primary-ray
coverage, restoring the silhouette term — the classic soft-rasterizer
trick, here applied to the 4D path tracer's primary hit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax

from fourd_ray_tracing_tpu import camera as cam
from fourd_ray_tracing_tpu.diff import (
    drop_sphere,
    image_loss,
    make_train_step,
    primary_coverage,
    soft_image_loss,
)
from fourd_ray_tracing_tpu.models.renderer import RenderConfig, render_image
from fourd_ray_tracing_tpu.models.scene import Scene, material, sphere
from fourd_ray_tracing_tpu.ops.vec4 import Vec4

# Primary-hit-only workload: 0 bounces isolates the silhouette.
CFG = RenderConfig(width=32, height=20, samples=1, reflections_amount=0,
                   light_coefficient=0.3)
SEED = 11


def default_camera():
    return cam.camera_from_state(
        Vec4.of(0.0, -2.0, 0.0, 0.0),
        cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)),
        1.5, 2.0,
    )


def glow_sphere_scene(cx=0.0, cz=0.0, r=0.6):
    """One flat emissive sphere, black environment: the image is a
    constant-intensity disk — position affects ONLY the silhouette."""
    return Scene(
        spheres=(sphere((cx, 1.5, cz, 0), r, material(10.0, 0.0, (1, 1, 1))),),
        environment=None,
    )


def test_hard_position_gradient_is_zero():
    camera = default_camera()
    target = render_image(glow_sphere_scene(cx=0.5), camera, CFG, SEED)

    def hard(cx):
        return image_loss(glow_sphere_scene(cx=cx), camera, CFG, SEED, target)

    g = float(jax.grad(hard)(jnp.float32(0.0)))
    assert g == 0.0  # boundary-blind by construction


def test_soft_position_gradient_points_at_target():
    camera = default_camera()
    target = render_image(glow_sphere_scene(cx=0.5), camera, CFG, SEED)

    def soft(cx):
        return soft_image_loss(
            glow_sphere_scene(cx=cx), camera, CFG, SEED, target,
            sphere_index=0, edge_width=0.08,
        )

    g = float(jax.grad(soft)(jnp.float32(0.0)))
    # Moving +x toward the target (at +0.5) must DECREASE the loss.
    assert g < -1e-6, g


def test_soft_radius_gradient_matches_fd():
    camera = default_camera()
    target = render_image(glow_sphere_scene(r=0.8), camera, CFG, SEED)

    def soft(r):
        return soft_image_loss(
            glow_sphere_scene(r=r), camera, CFG, SEED, target,
            sphere_index=0, edge_width=0.08,
        )

    ad = float(jax.grad(soft)(jnp.float32(0.6)))
    eps = 1e-3
    fd = (float(soft(jnp.float32(0.6 + eps))) - float(soft(jnp.float32(0.6 - eps)))) / (2 * eps)
    # The soft loss is smooth by construction: AD must track FD.
    np.testing.assert_allclose(ad, fd, rtol=0.05, atol=1e-4)
    assert ad < 0  # growing toward the target radius decreases loss


def test_inverse_rendering_recovers_position_through_silhouette():
    """Optimize a sphere POSITION from a
    target image where only the silhouette carries the signal."""
    camera = default_camera()
    true_cx = 0.5
    target = render_image(glow_sphere_scene(cx=true_cx), camera, CFG, SEED)

    opt = optax.adam(0.05)
    # Optimize only the sphere's center x.
    def param_filter(grads):
        zeroed = jax.tree.map(jnp.zeros_like, grads)
        keep = grads.spheres[0].center.x
        c = zeroed.spheres[0].center._replace(x=keep)
        return zeroed._replace(spheres=(zeroed.spheres[0]._replace(center=c),))

    step = make_train_step(
        CFG, opt, camera, param_filter=param_filter,
        soft_sphere_index=0, edge_width=0.08,
    )
    scene = glow_sphere_scene(cx=0.0)
    opt_state = opt.init(scene)
    for _ in range(120):
        scene, opt_state, loss, metrics = step(scene, opt_state, SEED, target)
    got = float(scene.spheres[0].center.x)
    assert abs(got - true_cx) < 0.08, f"recovered cx={got}, want {true_cx}"


def test_primary_coverage_limits():
    """alpha -> 1 well inside the silhouette, -> 0 well outside."""
    camera = default_camera()
    sp = glow_sphere_scene().spheres[0]
    alpha = np.asarray(primary_coverage(sp.center, sp.r, camera, CFG, 0.02))
    assert alpha.shape == (CFG.height, CFG.width)
    cy, cx_ = CFG.height // 2, CFG.width // 2
    assert alpha[cy, cx_] > 0.99      # disk center
    assert alpha[0, 0] < 0.01         # far corner
    assert np.isfinite(alpha).all()


def test_drop_sphere():
    s = glow_sphere_scene()
    assert drop_sphere(s, 0).spheres == ()


# --- Generalized per-primitive silhouette coverage ------------------

def glow_hypercube_scene(cx=0.0):
    """One flat emissive hypercube, black environment: only the
    silhouette carries position signal."""
    from fourd_ray_tracing_tpu.models.scene import Scene
    from fourd_ray_tracing_tpu.ops import geometry as geo
    from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as V

    mat = material(10.0, 0.0, (1, 1, 1))
    hc = geo.make_hypercube(
        V.of(cx, 1.8, 0.0, 0.0),
        V.of(1, 0, 0, 0), V.of(0, 1, 0, 0), V.of(0, 0, 1, 0), V.of(0, 0, 0, 1),
        0.5, (mat,) * 8,
    )
    return Scene(hypercube=hc, environment=None)


def glow_cylinder_scene(r=0.5):
    from fourd_ray_tracing_tpu.models.scene import Scene, cylinder

    mat = material(10.0, 0.0, (1, 1, 1))
    return Scene(
        cylinders=(cylinder((0, 1.8, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1), r, mat),),
        environment=None,
    )


def test_object_coverage_shapes_and_limits():
    from fourd_ray_tracing_tpu.diff import object_coverage
    from fourd_ray_tracing_tpu.models import library

    camera = default_camera()
    cases = [
        (glow_hypercube_scene(), ("hypercube", None)),
        (glow_cylinder_scene(), ("cylinders", 0)),
        (library.duocylinder(), ("cylinders_union", None)),
        (library.tiger(), ("tiger", None)),
        (library.sphere_plane_light(), ("spaces", 0)),
    ]
    for scene, ref in cases:
        alpha = np.asarray(object_coverage(scene, ref, camera, CFG, 0.05))
        assert alpha.shape == (CFG.height, CFG.width), ref
        assert np.isfinite(alpha).all(), ref
        assert alpha.min() >= 0.0 and alpha.max() <= 1.0, ref
        # every shipped case has the object visibly on-screen
        assert alpha.max() > 0.5, ref


def test_drop_object_all_kinds():
    from fourd_ray_tracing_tpu.diff import drop_object
    from fourd_ray_tracing_tpu.models import library

    assert drop_object(glow_hypercube_scene(), ("hypercube", None)).hypercube is None
    assert drop_object(library.tiger(), ("tiger", None)).tiger is None
    assert drop_object(
        library.duocylinder(), ("cylinders_union", None)
    ).cylinders_union is None
    assert drop_object(glow_cylinder_scene(), ("cylinders", 0)).cylinders == ()
    s = library.sphere_plane_light()
    assert len(drop_object(s, ("spaces", 0)).spaces) == len(s.spaces) - 1


def test_soft_recovers_hypercube_center_through_silhouette():
    """Optimize the hypercube CENTER from a
    target image where only the silhouette carries the signal."""
    from fourd_ray_tracing_tpu.diff import soft_image_loss

    camera = default_camera()
    true_cx = 0.4
    target = render_image(glow_hypercube_scene(cx=true_cx), camera, CFG, SEED)

    def hard(cx):
        return image_loss(glow_hypercube_scene(cx=cx), camera, CFG, SEED, target)

    assert float(jax.grad(hard)(jnp.float32(0.0))) == 0.0  # boundary-blind

    def soft(cx):
        return soft_image_loss(
            glow_hypercube_scene(cx=cx), camera, CFG, SEED, target,
            edge_width=0.08, object_ref=("hypercube", None),
        )

    # Gradient points toward the target…
    assert float(jax.grad(soft)(jnp.float32(0.0))) < -1e-6
    # …and gradient descent recovers the center.
    cx = jnp.float32(0.0)
    g = jax.jit(jax.grad(soft))
    for _ in range(60):
        cx = cx - 2.0 * g(cx)
    assert abs(float(cx) - true_cx) < 0.1, float(cx)


def test_soft_cylinder_radius_gradient_matches_fd():
    from fourd_ray_tracing_tpu.diff import soft_image_loss

    camera = default_camera()
    target = render_image(glow_cylinder_scene(r=0.7), camera, CFG, SEED)

    def soft(r):
        return soft_image_loss(
            glow_cylinder_scene(r=r), camera, CFG, SEED, target,
            edge_width=0.08, object_ref=("cylinders", 0),
        )

    ad = float(jax.grad(soft)(jnp.float32(0.5)))
    eps = 1e-3
    fd = (float(soft(jnp.float32(0.5 + eps))) - float(soft(jnp.float32(0.5 - eps)))) / (2 * eps)
    np.testing.assert_allclose(ad, fd, rtol=0.05, atol=1e-4)
    assert ad < 0  # growing toward the target radius decreases loss


def test_soft_recovers_duocylinder_center_through_silhouette():
    """Silhouette-driven recovery for the duocylinder family: optimize
    the duocylinder's center x from a target image."""
    from fourd_ray_tracing_tpu.diff import soft_image_loss
    from fourd_ray_tracing_tpu.models.scene import Scene, cylinder

    def duo_scene(cx):
        mat = material(10.0, 0.0, (1, 1, 1))
        c1 = cylinder((cx, 1.8, 0.0, 0.0), (0, 0, 1, 0), (0, 0, 0, 1), 0.5, mat)
        c2 = cylinder((cx, 1.8, 0.0, 0.0), (1, 0, 0, 0), (0, 1, 0, 0), 0.5, mat)
        return Scene(cylinders_union=(c1, c2), environment=None)

    camera = default_camera()
    true_cx = 0.35
    target = render_image(duo_scene(true_cx), camera, CFG, SEED)

    def soft(cx):
        return soft_image_loss(
            duo_scene(cx), camera, CFG, SEED, target,
            edge_width=0.08, object_ref=("cylinders_union", None),
        )

    g = jax.jit(jax.grad(soft))
    assert float(g(jnp.float32(0.0))) < -1e-7  # points toward the target
    cx = jnp.float32(0.0)
    for _ in range(60):
        cx = cx - 2.0 * g(cx)
    assert abs(float(cx) - true_cx) < 0.12, float(cx)


def test_soft_tiger_center_gradient_points_at_target():
    """Tiger silhouette coverage: the soft loss's gradient w.r.t. the
    tiger's center x points toward the target position."""
    from fourd_ray_tracing_tpu.diff import soft_image_loss
    from fourd_ray_tracing_tpu.models.scene import Scene
    from fourd_ray_tracing_tpu.ops import geometry as geo
    from fourd_ray_tracing_tpu.ops.vec4 import Vec4 as V

    def tiger_scene(cx):
        mat = material(10.0, 0.0, (1, 1, 1))
        tg = geo.make_tiger(
            V.of(cx, 2.2, 0.0, 0.0),
            V.of(1, 0, 0, 0), V.of(0, 1, 0, 0),
            V.of(0, 0, 1, 0), V.of(0, 0, 0, 1),
            0.35, 0.8, mat, mat,
        )
        return Scene(tiger=tg, environment=None)

    camera = default_camera()
    target = render_image(tiger_scene(0.5), camera, CFG, SEED)

    def soft(cx):
        return soft_image_loss(
            tiger_scene(cx), camera, CFG, SEED, target,
            edge_width=0.08, object_ref=("tiger", None),
        )

    g = float(jax.grad(soft)(jnp.float32(0.0)))
    assert g < -1e-7, g


# --- Mesh and minibatch soft training -------------------------------------

PS_CFG = RenderConfig(width=16, height=8, samples=1, reflections_amount=0,
                      light_coefficient=0.3, rng_mode="per_sample")


def test_soft_hyperplane_ref_on_mesh_matches_single_device():
    """soft_image_loss with a HYPERPLANE object ref shards over a mesh
    like any other ref (the jnp path has no zero-emulation limit): loss
    and gradient equal the one-device soft loss up to psum order."""
    from fourd_ray_tracing_tpu.models import library
    from fourd_ray_tracing_tpu.parallel.mesh import make_mesh

    scene = library.sphere_plane_light()
    camera = default_camera()
    target = jnp.zeros((PS_CFG.height, PS_CFG.width, 3), jnp.float32)
    mesh = make_mesh(rays=2, samples=1, devices=jax.devices()[:2])
    ref = ("spaces", 0)

    def loss(s, m):
        return soft_image_loss(s, camera, PS_CFG, SEED, target,
                               edge_width=0.08, mesh=m, object_ref=ref)

    l1, g1 = jax.jit(jax.value_and_grad(lambda s: loss(s, None)))(scene)
    ln, gn = jax.jit(jax.value_and_grad(lambda s: loss(s, mesh)))(scene)
    np.testing.assert_allclose(float(ln), float(l1), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(gn), jax.tree.leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                                   atol=1e-7)


def test_soft_train_step_with_minibatch_frames():
    """make_train_step(soft_object_ref=..., frames_per_step=2) runs the
    mean of two soft losses in one jit and moves the object."""
    scene = glow_sphere_scene(cx=0.0)
    camera = default_camera()
    target = render_image(glow_sphere_scene(cx=0.5), camera, CFG, SEED)
    opt = optax.adam(0.02)
    step = make_train_step(CFG, opt, camera, edge_width=0.08,
                           soft_object_ref=("spheres", 0), frames_per_step=2)
    new, _, loss, metrics = step(scene, opt.init(scene), np.uint32(SEED),
                                 target)
    assert np.isfinite(float(loss)) and float(metrics["grad_norm"]) > 0
    assert float(new.spheres[0].center.x) > 0.0
