"""Engine / frame-loop semantics tests (C2: main.cpp:79-106)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from fourd_ray_tracing_tpu import camera as cam
from fourd_ray_tracing_tpu.engine import RenderEngine
from fourd_ray_tracing_tpu.models import library
from fourd_ray_tracing_tpu.models.renderer import RenderConfig
from fourd_ray_tracing_tpu.ops.vec4 import Vec4


def make_engine(**kw):
    return RenderEngine(
        library.sphere_plane_light(),
        RenderConfig(width=32, height=20, samples=1, reflections_amount=2),
        focus=Vec4.of(0, -2, 0, 0),
        angles=cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)),
        deterministic=True,
        **kw,
    )


@pytest.mark.slow
def test_accumulation_reduces_noise():
    eng = make_engine()
    eng.step_frame()
    f1 = np.asarray(eng.accum)
    acc = np.asarray(eng.run(15))
    # Accumulated frame should differ from frame 1 (it averaged noise).
    assert np.abs(acc - f1).max() > 1e-4
    assert np.isfinite(acc).all()
    # Variance of accumulated image vs a single frame, against an
    # independent single frame: accumulation = running mean.
    eng2 = make_engine()
    eng2.step_frame()
    f_other = np.asarray(eng2.accum)
    # noise between two 16-frame averages < noise between two 1-frame images
    eng3 = make_engine()
    acc3 = np.asarray(eng3.run(16))
    assert np.abs(acc - acc3).mean() <= np.abs(f1 - f_other).mean() + 1e-5


def test_camera_motion_resets_accumulation():
    eng = make_engine()
    eng.run(5)
    assert eng.frame_number == 6
    eng.rotate(d_fi=0.01)
    assert eng.frame_number == 1
    eng.run(2)
    assert eng.frame_number == 3
    eng.move(cam.MoveKeys(forward=True), 0.1)
    assert eng.frame_number == 1
    eng.move(cam.MoveKeys(), 0.1)  # no keys held -> no reset
    assert eng.frame_number == 1


def test_first_frame_equals_plain_render():
    # part = 1/1 on the first frame: accumulation == fresh render.
    eng = make_engine()
    out = np.asarray(eng.step_frame())
    from fourd_ray_tracing_tpu.models.renderer import render_image

    direct = np.asarray(
        render_image(eng.scene, eng._camera(), eng.cfg, np.uint32(eng.seed))
    )
    # jit fuses the blend into the render; ulp-level compile differences
    # may flip discrete path outcomes on a few silhouette pixels.
    from helpers import assert_images_close

    assert_images_close(out, direct, atol=1e-5, boundary_frac=0.05)


@pytest.mark.slow
def test_three_view_engine_shapes():
    eng = RenderEngine(
        library.tiger(),
        RenderConfig(width=16, height=12, samples=1, reflections_amount=1),
        focus=Vec4.of(0, -2, 0, 0),
        angles=cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)),
        views=cam.VIEWS_ALL,
        deterministic=True,
    )
    out = np.asarray(eng.step_frame())
    assert out.shape == (3, 12, 16, 3)


def test_psi_constraint_clamps():
    eng = make_engine(psi_constraint=(0.0, np.float32(np.radians(45))))
    eng.rotate(d_psi=10.0)
    assert abs(float(eng.angles.psi)) <= np.radians(45) + 1e-5


def test_native_and_python_controls_agree():
    """The native camera state machine (controls.cc) drives the viewer in
    production; it must track the pure-Python camera exactly through a
    rotation/movement sequence."""
    import pytest

    try:
        from fourd_ray_tracing_tpu.native import binding
        binding.load()
    except Exception:
        pytest.skip("native toolchain unavailable")

    engines = [
        make_engine(use_native_controls=mode, psi_constraint=(0.0, 0.8))
        for mode in ("native", "python")
    ]
    assert engines[0]._native is not None and engines[1]._native is None
    for eng in engines:
        eng.rotate(d_fi=0.3, d_te=-0.2, d_psi=0.5)
        eng.mouse_sensitivity = 0.01
        assert eng.mouse_moved(7, -3)
        eng.wheel_scrolled(2.5)
        eng.move(cam.MoveKeys(forward=True, right=True, w_pos=True), 0.4)
        eng.rotate(d_fi=4.0)  # wraps past pi
    a, b = engines
    for name in ("fi", "te", "psi"):
        np.testing.assert_allclose(
            float(getattr(a.angles, name)), float(getattr(b.angles, name)),
            atol=1e-6, err_msg=name,
        )
    for va, vb in zip(a.focus, b.focus):
        np.testing.assert_allclose(float(va), float(vb), atol=1e-6)
    oa, ob = a.orientation(), b.orientation()
    for f in ("forward", "top", "right", "w_drct"):
        for ca, cb in zip(getattr(oa, f), getattr(ob, f)):
            np.testing.assert_allclose(float(ca), float(cb), atol=1e-6)


@pytest.mark.slow
def test_additional_group_resolution_and_windows():
    eng = RenderEngine(
        library.tiger(),
        RenderConfig(width=16, height=12, samples=1, reflections_amount=1),
        focus=Vec4.of(0, -2, 0, 0),
        angles=cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)),
        views=("yxz",),
        additional=(
            RenderConfig(width=8, height=5, samples=1, reflections_amount=1),
            ("ywz", "yxw"),
        ),
        deterministic=True,
    )
    eng.step_frame()
    wins = dict(eng.windows())
    assert set(wins) == {"yxz", "ywz", "yxw"}
    assert wins["yxz"].shape == (12, 16, 3)
    assert wins["ywz"].shape == (5, 8, 3)
    assert wins["yxw"].shape == (5, 8, 3)
    assert eng.rays_per_frame() == 16 * 12 + 2 * 8 * 5
    # Additional views must equal a standalone render at their own
    # resolution (same camera, same seed).
    from fourd_ray_tracing_tpu.models.renderer import render_image

    cfga = eng.groups[1].cfg
    direct = np.asarray(render_image(
        eng.scene, eng.groups[1].camera(eng), cfga, np.uint32(eng.seed)
    ))
    from helpers import assert_images_close

    # jit (fused accumulate) vs eager: silhouette pixels may flip.
    assert_images_close(np.asarray(eng.groups[1].accum), direct,
                        atol=1e-5, boundary_frac=0.06)


def test_step_frames_matches_single_steps():
    """step_frames(n) (one dispatch per group) must
    reproduce n step_frame calls exactly: same seed/part sequence, same
    accumulation, same engine counters."""
    eng_a = make_engine()
    eng_b = make_engine()
    eng_a.step_frame()  # mixed usage: single step, then a batch
    eng_b.step_frame()
    for _ in range(5):
        eng_a.step_frame()
    eng_b.step_frames(5)
    assert eng_a.frame_number == eng_b.frame_number
    assert eng_a.seed == eng_b.seed
    np.testing.assert_allclose(
        np.asarray(eng_a.accum), np.asarray(eng_b.accum), atol=1e-6
    )


def test_step_frames_chunking_matches_single_steps():
    """A request crossing STEP_CHUNKS boundaries (9 = 8 + 1 with the
    default chunk set) decomposes into fixed-size dispatches (no fresh
    compile per distinct n) while staying bit-identical to n single
    steps."""
    eng_a = make_engine()
    eng_b = make_engine()
    assert 8 in eng_b.STEP_CHUNKS
    for _ in range(9):
        eng_a.step_frame()
    eng_b.step_frames(9)
    assert eng_a.frame_number == eng_b.frame_number
    assert eng_a.seed == eng_b.seed
    np.testing.assert_array_equal(
        np.asarray(eng_a.accum), np.asarray(eng_b.accum)
    )


def test_precompile_preserves_state_and_results():
    """engine.precompile() (the --precompile warm start)
    must not perturb the seed sequence, frame counter, or accumulation:
    a warmed engine renders bit-identical frames to a cold one."""
    cold = make_engine()
    warm = make_engine()
    secs = warm.precompile()
    assert secs >= 0.0
    assert warm.frame_number == cold.frame_number
    assert warm.seed == cold.seed
    np.testing.assert_array_equal(np.asarray(warm.accum), np.asarray(cold.accum))
    cold.step_frames(3)
    warm.step_frames(3)
    np.testing.assert_array_equal(np.asarray(warm.accum), np.asarray(cold.accum))


@pytest.mark.parametrize("controls", ["native", "python"])
def test_launch_cameras_follow_every_camera_change(controls):
    """The per-launch cameras are built once per camera state: every
    change (rotate, move, focus, angles) rebuilds them, and they always
    equal a freshly built camera."""
    if controls == "native":
        from fourd_ray_tracing_tpu.native import binding

        try:
            binding.load()
        except Exception:
            pytest.skip("native toolchain unavailable")
    eng = make_engine(use_native_controls=controls)

    def leaves(c):
        return [np.asarray(x) for x in jax.tree_util.tree_leaves(c)]

    changes = (
        lambda: eng.rotate(d_fi=0.2, d_te=-0.1),
        lambda: eng.move(cam.MoveKeys(forward=True, w_pos=True), 0.5),
        lambda: setattr(eng, "focus", Vec4.of(0.3, -1.5, 0.1, 0.2)),
        lambda: setattr(eng, "angles", cam.CameraAngles(
            jnp.float32(0.4), jnp.float32(0.1), jnp.float32(-0.2))),
    )
    before = leaves(eng._launch_cameras()[0])
    for change in changes:
        change()
        now = leaves(eng._launch_cameras()[0])
        fresh = leaves(eng.groups[0].camera(eng))
        for a, b in zip(now, fresh):
            np.testing.assert_array_equal(a, b)
        assert any((a != b).any() for a, b in zip(now, before))
        before = now
