"""Smoke test of rendering and training on one NVIDIA GPU.

Drives the system's two user paths through their normal entry points at
real sizes, in ONE process (one JAX process per card):

1. app      — `app.main` on configs/properties.txt (the reference's
              interactive setup: tiger, a 121x75 main view and two
              60x37 views, 100 spp): PNGs written and not blank.
2. forward  — `RenderEngine` on room_with_sphere at 1280x720, 8 spp,
              4 bounces, impl="auto" (the Triton kernel on a GPU); the
              kernel against the jnp pipeline compiled by XLA at full
              width, and both against the oracle goldens.
3. timing   — kernel vs XLA through `engine.step_launch`, interleaved
              turns (XLA, kernel, kernel, XLA), for the room cell, the
              tiger three-view cell and the reference's interactive setup.
4. train    — `make_train_step` (3 adam steps toward a target rendered
              from the true scene, loss must fall), `make_packed_train_step`,
              frames_per_step=4 and a soft-silhouette step, all at
              1280x720x8x4; the card's loss and gradient against the CPU's
              at a small size; peak device memory.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Without a GPU the script exits non-zero and prints no result.

    python chip_smoke.py               # one card, phases 1-4
    python chip_smoke.py --four-cards  # four cards: sharded render + train
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from helpers import assert_images_close  # noqa: E402

from fourd_ray_tracing_tpu import app as app_mod  # noqa: E402
from fourd_ray_tracing_tpu import camera as cam  # noqa: E402
from fourd_ray_tracing_tpu.diff import (  # noqa: E402
    image_loss,
    make_packed_train_step,
    make_train_step,
)
from fourd_ray_tracing_tpu.engine import RenderEngine  # noqa: E402
from fourd_ray_tracing_tpu.models import library  # noqa: E402
from fourd_ray_tracing_tpu.models.renderer import (  # noqa: E402
    RenderConfig,
    render_image,
    render_light,
)
from fourd_ray_tracing_tpu.ops.pallas.megakernel import (  # noqa: E402
    render_image_pallas,
    render_light_pallas,
)
from fourd_ray_tracing_tpu.ops.vec4 import Vec4  # noqa: E402
from fourd_ray_tracing_tpu.utils.config import AppConfig  # noqa: E402
from fourd_ray_tracing_tpu.utils.image import read_png  # noqa: E402

FOCUS = (0.0, -2.0, 0.0, 0.0)
CONFIG = REPO / "configs" / "properties.txt"
CARD = "unknown card"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def report(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields, "card": CARD}), flush=True)


def camera_for(views=("yxz",)):
    angles = cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0))
    if len(views) == 1:
        return cam.camera_from_state(Vec4.of(*FOCUS), angles, 1.5, 2.0,
                                     view=views[0])
    orient = cam.orientation_from_angles(angles.fi, angles.te, angles.psi)
    tops, rights = cam.batched_view_bases(orient, views)
    return cam.Camera(
        focus=Vec4.of(*FOCUS), vec_to_mtr=orient.forward * jnp.float32(1.5),
        top=tops, right=rights,
        mtr_width=jnp.float32(2.0) * cam.GOLDEN, mtr_height=jnp.float32(2.0),
    )


def render_cfg(width, height, samples, bounces, **kw):
    return RenderConfig(width=width, height=height, samples=samples,
                        reflections_amount=bounces, rng_mode="per_sample",
                        light_coefficient=0.12, **kw)


# --- 1. app ------------------------------------------------------------------

def phase_app(config=CONFIG, frames: int = 8, out_dir=None) -> dict:
    """`app.main` end to end; every window's PNG decodes and is not
    blank (more than one distinct value)."""
    out_dir = Path(out_dir or tempfile.mkdtemp(prefix="chip_smoke_app_"))
    t0 = time.perf_counter()
    rc = app_mod.main(["--config", str(config), "--frames", str(frames),
                       "--out", str(out_dir)])
    seconds = time.perf_counter() - t0
    assert rc == 0, f"app.main returned {rc}"
    pngs = sorted(out_dir.glob("*.png"))
    app = AppConfig.load(config)
    want = 3 if app.show_additional_windows else 1
    assert len(pngs) == want, f"{len(pngs)} PNGs written, want {want}"
    shapes = {}
    for p in pngs:
        img = read_png(p)
        assert len(np.unique(img)) > 1, f"{p.name} is blank"
        shapes[p.stem] = list(img.shape)
    return {"pngs": shapes, "seconds_incl_compile": seconds}


# --- 2. forward --------------------------------------------------------------

def _jit_light(scene, camera, cfg):
    return jax.jit(lambda seed: render_light(scene, camera, cfg, seed))


def compare_kernel_xla(scene_name, views, width, height, samples, bounces,
                       interpret=False) -> dict:
    """The kernel against the jnp pipeline compiled by XLA, same seed.

    Tolerances: primary-hit geometry (0 bounces, 1 spp) differs only
    where the two compilers' ulps flip a hit test on a silhouette, so
    all but 0.5% of pixels match to 1e-5 and the mean to 1e-5.
    Multi-bounce light also inherits ulp differences of transcendental
    functions (Triton's libdevice vs XLA's), which a diffuse bounce
    amplifies into a different path: all but 1% of pixels to 1e-4, the
    mean to 1e-4."""
    scene = library.SCENES[scene_name]()
    camera = camera_for(views)
    out = {}
    for label, cfg, atol, frac, mean in (
        ("primary", render_cfg(width, height, 1, 0), 1e-5, 0.005, 1e-5),
        ("multibounce", render_cfg(width, height, samples, bounces),
         1e-4, 0.01, 1e-4),
    ):
        k = np.asarray(render_light_pallas(scene, camera, cfg, np.uint32(7),
                                           interpret=interpret))
        x = np.asarray(_jit_light(scene, camera, cfg)(np.uint32(7)))
        assert_images_close(k, x, atol=atol, boundary_frac=frac,
                            mean_atol=mean)
        d = np.abs(k - x)
        out[label] = {
            "max_abs": float(d.max()), "mean_abs": float(d.mean()),
            "frac_over_atol": float((d.reshape(-1, 3).max(-1) > atol).mean()),
            "tolerance": {"atol": atol, "boundary_frac": frac,
                          "mean_atol": mean},
        }
    return out


def compare_goldens(interpret=False, scenes=None) -> dict:
    """Kernel and XLA renders against the oracle goldens at their own
    size, with test_oracle.py's bounds (<= 10% of pixels over 1e-3 after
    tone mapping, mean <= 0.01). ``scenes``: golden names (default all)."""
    from tools.gen_goldens import B_BOUNCES, B_H, B_SPP, B_W, SEED

    cfg = RenderConfig(width=B_W, height=B_H, samples=B_SPP,
                       reflections_amount=B_BOUNCES, sampler_method="newton",
                       rng_mode="per_sample", intersect="spec")
    camera = camera_for()

    def stats(light, gold):
        tm = lambda l: 1.0 - 1.0 / (0.12 * np.asarray(l, np.float64) + 1.0)
        d = np.abs(tm(light) - tm(gold))
        return float((d.reshape(-1, 3).max(-1) > 1e-3).mean()), float(d.mean())

    out = {}
    for path in sorted((REPO / "tests" / "goldens").glob("*.npz")):
        if scenes is not None and path.stem not in scenes:
            continue
        gold = np.load(path)["b_per"]
        scene = library.SCENES[path.stem]()
        for impl, light in (
            ("pallas", render_light_pallas(scene, camera, cfg, np.uint32(SEED),
                                           interpret=interpret)),
            ("xla", _jit_light(scene, camera, cfg)(np.uint32(SEED))),
        ):
            frac, mean = stats(light, gold)
            assert frac <= 0.10 and mean <= 0.01, (path.stem, impl, frac, mean)
            out[f"{path.stem}/{impl}"] = [round(frac, 4), round(mean, 5)]
    return out


def phase_forward(width=1280, height=720, samples=8, bounces=4, frames=4,
                  impl="auto", interpret=False, goldens=True) -> dict:
    """RenderEngine through its normal entry point, then the kernel
    against XLA on the room and the tiger three-view at full width,
    then the goldens."""
    scene = library.room_with_sphere()
    engine = RenderEngine(
        scene, render_cfg(width, height, samples, bounces), Vec4.of(*FOCUS),
        cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)),
        deterministic=True, impl=impl, interpret=interpret,
    )
    acc = np.asarray(jax.block_until_ready(engine.step_frames(frames)))
    assert acc.shape == (height, width, 3) and np.isfinite(acc).all()
    assert acc.max() > 0.0, "engine accumulated a black image"
    out = {
        "engine_impl": engine.impl,
        "room": compare_kernel_xla("room_with_sphere", ("yxz",), width,
                                   height, samples, bounces, interpret),
        "tiger_3view": compare_kernel_xla("tiger", cam.VIEWS_ALL, width,
                                          height, samples, bounces, interpret),
    }
    if goldens:
        out["goldens_frac_mean"] = compare_goldens(interpret)
    return out


# --- 3. timing ---------------------------------------------------------------

def time_engines(make_engine, frames_per_launch: int, launches: int) -> dict:
    """rays/s of the kernel and of XLA through `engine.step_launch`, in
    interleaved turns XLA, kernel, kernel, XLA (one process, warmed up,
    each turn ending in block_until_ready). ``make_engine(impl)``
    builds a fresh engine."""
    engines = {impl: make_engine(impl) for impl in ("xla", "pallas")}
    for e in engines.values():  # compile + warm
        e.step_launch(frames_per_launch)
        jax.block_until_ready([g.accum for g in e.groups])
    spent = {"xla": 0.0, "pallas": 0.0}
    for impl in ("xla", "pallas", "pallas", "xla"):
        e = engines[impl]
        t0 = time.perf_counter()
        for _ in range(launches):
            e.step_launch(frames_per_launch)
        jax.block_until_ready([g.accum for g in e.groups])
        spent[impl] += time.perf_counter() - t0
    rays = engines["xla"].rays_per_frame() * frames_per_launch * launches * 2
    frames = frames_per_launch * launches * 2
    return {
        impl: {"rays_per_s": rays / spent[impl],
               "ms_per_frame": 1e3 * spent[impl] / frames}
        for impl in spent
    } | {"kernel_speedup": spent["xla"] / spent["pallas"],
         "frames_per_launch": frames_per_launch,
         "rays_per_frame": engines["xla"].rays_per_frame()}


def _engine_factory(scene_name, views, cfg, interpret):
    def make(impl):
        return RenderEngine(
            library.SCENES[scene_name](), cfg, Vec4.of(*FOCUS),
            cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)),
            views=views, deterministic=True, impl=impl,
            interpret=interpret and impl == "pallas",
        )
    return make


def phase_timing(width=1280, height=720, samples=8, bounces=4,
                 interactive=CONFIG, launches=10, interpret=False) -> dict:
    """The three configurations kernel vs XLA: the room at 4 frames per
    launch, the tiger with three views at 4 frames per launch, and the
    reference's interactive setup (two view groups) at 1 frame per
    launch, as the live viewer steps it."""
    cfg = render_cfg(width, height, samples, bounces)
    out = {
        "room_1280x720x8x4": time_engines(
            _engine_factory("room_with_sphere", ("yxz",), cfg, interpret),
            4, launches),
        "tiger_3view_1280x720x8x4": time_engines(
            _engine_factory("tiger", cam.VIEWS_ALL, cfg, interpret),
            4, launches),
    }
    app = AppConfig.load(interactive)
    out["interactive_properties"] = time_engines(
        lambda impl: app_mod.build_engine(
            app, deterministic=True, impl=impl,
            interpret=interpret and impl == "pallas"),
        1, launches * 4)
    return out


# --- 4. train ----------------------------------------------------------------

WALL = 2  # the room's back wall, facing the camera


def _perturbed_room():
    """The room with the back wall's color shifted, and a gradient filter
    that trains that color only (the fixed-seed estimator's noise on
    other parameters cannot then mask the descent)."""
    true = library.room_with_sphere()

    def with_wall(scene, wall):
        return scene._replace(
            spaces=scene.spaces[:WALL] + (wall,) + scene.spaces[WALL + 1:])

    wall = true.spaces[WALL]
    c = wall.material.color
    color = c._replace(x=c.x - 0.2, y=c.y + 0.15, z=c.z + 0.1)
    start = with_wall(true, wall._replace(
        material=wall.material._replace(color=color)))

    def only_wall_color(g):
        z = jax.tree.map(jnp.zeros_like, g)
        zw = z.spaces[WALL]
        return with_wall(z, zw._replace(material=zw.material._replace(
            color=g.spaces[WALL].material.color)))

    return true, start, only_wall_color


def _timed_steps(run, n):
    """(seconds per call, last output) of ``run(k)`` over n calls after
    one warm call."""
    jax.block_until_ready(run(0))
    t0 = time.perf_counter()
    for k in range(1, n + 1):
        out = run(k)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n, out


def _peak_bytes():
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _step_stats(step, args, sec, rays) -> dict:
    """Rate of a jitted train step, its compiled scratch memory (XLA's
    memory analysis of that one program) and the process's peak device
    memory so far."""
    mem = step.lower(*args).compile().memory_analysis()
    return {"s_per_step": sec, "rays_per_s": rays / sec,
            "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
            "peak_bytes_in_use": _peak_bytes()}


def compare_with_cpu(width=64, height=32, samples=2, bounces=2) -> dict:
    """Loss and scene gradient on the default device against the same
    computation on the host CPU, in this process. Tolerance: loss to
    1e-4 relative, gradient vector to 1e-2 relative in L2 norm — the two
    compilers' transcendental functions and reduction orders differ in
    the last ulps, which flip a few discrete path outcomes (hit/miss,
    mirror/diffuse) and with them whole gradient terms."""
    scene = library.room_with_sphere()
    camera = camera_for()
    cfg = render_cfg(width, height, samples, bounces)
    target = jnp.full((height, width, 3), 0.25, jnp.float32)
    vg = jax.jit(jax.value_and_grad(
        lambda s, t: image_loss(s, camera, cfg, np.uint32(3), t)))
    l_dev, g_dev = vg(scene, target)
    cpu = jax.devices("cpu")[0]
    l_cpu, g_cpu = vg(jax.device_put(scene, cpu), jax.device_put(target, cpu))
    flat = lambda g: np.concatenate(
        [np.asarray(l, np.float64).reshape(-1) for l in jax.tree.leaves(g)])
    gd, gc = flat(g_dev), flat(g_cpu)
    assert np.linalg.norm(gc) > 0
    rel = float(np.linalg.norm(gd - gc) / np.linalg.norm(gc))
    np.testing.assert_allclose(float(l_dev), float(l_cpu), rtol=1e-4)
    assert rel < 1e-2, f"gradient rel L2 error {rel:.3g}"
    return {"loss_device": float(l_dev), "loss_cpu": float(l_cpu),
            "grad_rel_l2": rel, "size": [width, height, samples, bounces]}


def train_descent(cfg, camera, target, start, only_wall_color, steps):
    """``steps`` adam steps of `make_train_step` from the perturbed
    room toward the target: the loss must be finite and fall."""
    opt = optax.adam(0.05)
    step = make_train_step(cfg, opt, camera, param_filter=only_wall_color)
    scene, state, losses, t_steps = start, opt.init(start), [], []
    for _ in range(steps + 1):
        t0 = time.perf_counter()
        scene, state, loss, _ = step(scene, state, np.uint32(5), target)
        losses.append(float(loss))  # float() waits for the step
        t_steps.append(time.perf_counter() - t0)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    sec = float(np.mean(t_steps[1:]))
    rays = cfg.width * cfg.height * cfg.samples
    return {"losses": losses, **_step_stats(
        step, (start, opt.init(start), np.uint32(5), target), sec, rays)}


def train_timed(cfg, camera, target, start, steps, packed=False,
                frames=1, soft=False):
    """One builder's step timed over ``steps`` calls from the same
    state; its losses must be finite."""
    opt = optax.adam(0.05)
    if packed:
        step, init, _ = make_packed_train_step(cfg, opt, camera, start,
                                               frames_per_step=frames)
        state = init(start)
    else:
        step = make_train_step(
            cfg, opt, camera, frames_per_step=frames,
            soft_object_ref=("spheres", 0) if soft else None)
        state = (start, opt.init(start))
    sec, loss = _timed_steps(
        lambda k: step(*state, np.uint32(k), target)[2], steps)
    assert np.isfinite(float(loss)), float(loss)
    rays = cfg.width * cfg.height * cfg.samples * frames
    return {"loss": float(loss), **_step_stats(
        step, (*state, np.uint32(1), target), sec, rays)}


TRAIN_PARTS = ("train_step", "packed_step", "packed_minibatch4_step",
               "minibatch4_step", "soft_step", "vs_cpu")


def phase_train(width=1280, height=720, samples=8, bounces=4, steps=3,
                small=(64, 32, 2, 2), parts=TRAIN_PARTS) -> dict:
    """The training builders at full width (see the module docstring);
    ``parts`` picks a subset of TRAIN_PARTS."""
    cfg = render_cfg(width, height, samples, bounces)
    camera = camera_for()
    true, start, only_wall_color = _perturbed_room()
    target = jax.jit(lambda s: render_image(true, camera, cfg, s))(np.uint32(5))
    run = {
        "train_step": lambda: train_descent(cfg, camera, target, start,
                                            only_wall_color, steps),
        "packed_step": lambda: train_timed(cfg, camera, target, start, steps,
                                           packed=True),
        "packed_minibatch4_step": lambda: train_timed(
            cfg, camera, target, start, steps, packed=True, frames=4),
        "minibatch4_step": lambda: train_timed(cfg, camera, target, start,
                                               steps, frames=4),
        "soft_step": lambda: train_timed(cfg, camera, target, start, steps,
                                         soft=True),
        "vs_cpu": lambda: compare_with_cpu(*small),
    }
    return {part: run[part]() for part in parts}


# --- four cards --------------------------------------------------------------

def phase_four_cards(width=1280, height=720, samples=8, bounces=4,
                     kernel_impl="pallas", interpret=False) -> dict:
    """Sharded rendering (both impls, 4x1 and 2x2 meshes) and the sharded
    train step against one device. The kernel's block axis shards
    bit-identically; the jnp pipeline's sample psum and the gradient
    all-reduce re-associate float sums (tolerances below)."""
    from fourd_ray_tracing_tpu.parallel.mesh import (
        jit_sharded_renderer,
        make_mesh,
    )

    devices = jax.devices()[:4]
    assert len(devices) == 4, f"{len(devices)} devices, want 4"
    cfg = render_cfg(width, height, samples, bounces)
    scene = library.room_with_sphere()
    camera = camera_for()
    seed = np.uint32(77)
    single_k = jax.jit(lambda s, c, sd: render_image_pallas(
        s, c, cfg, sd, interpret=interpret))(scene, camera, seed)
    single_x = jax.jit(lambda s, c, sd: render_image(s, c, cfg, sd))(
        scene, camera, seed)
    out = {}
    for rays_axis, samples_axis in ((4, 1), (2, 2)):
        mesh = make_mesh(rays=rays_axis, samples=samples_axis, devices=devices)
        key = f"{rays_axis}x{samples_axis}"
        got = jit_sharded_renderer(cfg, mesh, impl=kernel_impl,
                                   interpret=interpret)(scene, camera, seed)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(single_k))
        got = jit_sharded_renderer(cfg, mesh, impl="xla")(scene, camera, seed)
        err = float(np.abs(np.asarray(got) - np.asarray(single_x)).max())
        assert err <= 2e-6, f"xla sharded render {key}: max err {err}"
        out[f"render_{key}"] = {"kernel": "bitwise", "xla_max_abs": err}

    true, start, _ = _perturbed_room()
    target = jax.jit(lambda s: render_image(true, camera, cfg, s))(seed)
    opt = optax.adam(1e-2)
    mesh = make_mesh(rays=2, samples=2, devices=devices)
    _, _, l1, m1 = make_train_step(cfg, opt, camera)(
        start, opt.init(start), seed, target)
    _, _, ln, mn = make_train_step(cfg, opt, camera, mesh=mesh)(
        start, opt.init(start), seed, target)
    vg = lambda m: jax.jit(jax.grad(
        lambda s: image_loss(s, camera, cfg, seed, target, m)))(start)
    flat = lambda g: np.concatenate(
        [np.asarray(l, np.float64).reshape(-1) for l in jax.tree.leaves(g)])
    g1, gn = flat(vg(None)), flat(vg(mesh))
    rel = float(np.linalg.norm(gn - g1) / np.linalg.norm(g1))
    # Float32 sums over ~1e6 pixels split four ways: loss to 1e-5,
    # gradient norm and vector to 1e-4 relative.
    np.testing.assert_allclose(float(ln), float(l1), rtol=1e-5)
    np.testing.assert_allclose(float(mn["grad_norm"]), float(m1["grad_norm"]),
                               rtol=1e-4)
    assert rel < 1e-4, f"sharded gradient rel L2 error {rel:.3g}"
    out["train_2x2"] = {"loss_1": float(l1), "loss_4": float(ln),
                        "grad_rel_l2": rel}
    return out


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card checks (sharded render "
                    "and train step against one device)")
    args = ap.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform!r} devices",
              file=sys.stderr)
        return 1
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"{len(devices)} GPU(s), need {want}", file=sys.stderr)
        return 1
    CARD = card_line()
    print(f"card: {CARD}", flush=True)
    report("start", device_kind=devices[0].device_kind,
           jax_version=jax.__version__)

    phases = ([("four_cards", phase_four_cards)] if args.four_cards else
              [("app", phase_app), ("forward", phase_forward),
               ("timing", phase_timing), ("train", phase_train)])
    for name, fn in phases:
        t0 = time.perf_counter()
        result = fn()
        report(name, seconds=time.perf_counter() - t0, **result)

    print(f"card: {CARD}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": want,
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
