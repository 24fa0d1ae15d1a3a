"""App driver, checkpoint, PNG writer, and profiling meter tests
(auxiliary subsystems of SURVEY §5)."""
import json
import struct
import zlib

import numpy as np
import pytest

from fourd_ray_tracing_tpu import app as app_mod
from fourd_ray_tracing_tpu.utils import checkpoint
from fourd_ray_tracing_tpu.utils.config import AppConfig
from fourd_ray_tracing_tpu.utils.image import write_png
from fourd_ray_tracing_tpu.utils.profiling import Meter

TINY_CONFIG = """
show_additional_windows = false
window.main.title = Main section
window.main.width = 96
window.main.cell_size = 4
window.additional.width = 60
window.additional.cell_size = 10
ray_tracing.samples = 2
ray_tracing.reflections_amount = 2
ray_tracing.small_indent = 0.005
camera.focus_to_matrix_distance = 1.5
camera.matrix_height = 2.0
camera.initial_position.x = 0.0
camera.initial_position.y = -2.0
camera.initial_position.z = 0.0
camera.initial_position.w = 0.0
camera.initial_position.fi = 0.0
camera.initial_position.te = 0.0
camera.initial_position.psi = 0.0
mouse_border_width = 15
constrain_psi_range = true
psi_range_radius = 45.0
mouse_sensitivity = 0.005
wheel_sensitivity = 0.1
movement_speed = 3.0
light_to_color_conversion_coefficient = 1.0
max_fps = 60
scene = sphere_plane_light
"""


@pytest.fixture
def tiny_config(tmp_path):
    p = tmp_path / "properties.txt"
    p.write_text(TINY_CONFIG)
    return p


def read_png_header(path):
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    length = struct.unpack(">I", data[8:12])[0]
    assert data[12:16] == b"IHDR"
    w, h = struct.unpack(">II", data[16:24])
    return w, h, data


def test_headless_main_renders_and_saves(tiny_config, tmp_path, capsys):
    out = tmp_path / "out"
    rc = app_mod.main([
        "--config", str(tiny_config), "--frames", "2",
        "--out", str(out), "--deterministic",
    ])
    assert rc == 0
    pngs = sorted(out.glob("*.png"))
    assert len(pngs) == 1  # single window (show_additional_windows=false)
    w, h, _ = read_png_header(pngs[0])
    assert (w, h) == (24, 14)  # 96/4 x (96/GOLDEN=59)//4
    text = capsys.readouterr().out
    assert "rays_per_s" in text


@pytest.mark.slow
def test_headless_main_three_views(tiny_config, tmp_path):
    cfg_text = TINY_CONFIG.replace(
        "show_additional_windows = false", "show_additional_windows = true"
    )
    p = tmp_path / "p3.txt"
    p.write_text(cfg_text)
    out = tmp_path / "out3"
    rc = app_mod.main([
        "--config", str(p), "--frames", "1", "--out", str(out),
        "--deterministic",
    ])
    assert rc == 0
    assert {q.stem for q in out.glob("*.png")} == {"yxz", "ywz", "yxw"}
    # Additional views render at window.additional cells (60/10=6 wide,
    # (60/GOLDEN=37)//10=3 high), NOT the main window's resolution.
    assert read_png_header(out / "yxz.png")[:2] == (24, 14)
    assert read_png_header(out / "ywz.png")[:2] == (6, 3)
    assert read_png_header(out / "yxw.png")[:2] == (6, 3)


def test_reference_window_resolutions(tmp_path):
    """The reference's default window config
    (window.main 850/7, window.additional 600/10 — properties.txt:6-13)
    yields a 121x75 main PNG and two 60x37 additional PNGs
    (windows.cpp:6-13, 24-28)."""
    cfg_text = (
        TINY_CONFIG
        .replace("show_additional_windows = false", "show_additional_windows = true")
        .replace("window.main.width = 96", "window.main.width = 850")
        .replace("window.main.cell_size = 4", "window.main.cell_size = 7")
        .replace("window.additional.width = 60", "window.additional.width = 600")
        .replace("ray_tracing.samples = 2", "ray_tracing.samples = 1")
        .replace("ray_tracing.reflections_amount = 2",
                 "ray_tracing.reflections_amount = 0")
    )
    p = tmp_path / "pref.txt"
    p.write_text(cfg_text)
    out = tmp_path / "outref"
    rc = app_mod.main([
        "--config", str(p), "--frames", "1", "--out", str(out),
        "--deterministic",
    ])
    assert rc == 0
    assert read_png_header(out / "yxz.png")[:2] == (121, 75)
    assert read_png_header(out / "ywz.png")[:2] == (60, 37)
    assert read_png_header(out / "yxw.png")[:2] == (60, 37)


def test_upscale_blit(tiny_config, tmp_path):
    """--upscale replicates each pixel cell_size x cell_size, like the
    sprite blit (windows.cpp:33)."""
    cfg_text = TINY_CONFIG.replace(
        "show_additional_windows = false", "show_additional_windows = true"
    )
    p = tmp_path / "pu.txt"
    p.write_text(cfg_text)
    out = tmp_path / "outu"
    rc = app_mod.main([
        "--config", str(p), "--frames", "1", "--out", str(out),
        "--deterministic", "--upscale",
    ])
    assert rc == 0
    assert read_png_header(out / "yxz.png")[:2] == (24 * 4, 14 * 4)
    assert read_png_header(out / "ywz.png")[:2] == (6 * 10, 3 * 10)


def test_interactive_loop_commands(tiny_config, tmp_path, monkeypatch, capsys):
    import io
    save_dir = tmp_path / "saved"
    cmds = f"capture\nframes 2\nw 0.1\nlook 0.05 0.0\nstats\nsave {save_dir}\nbogus\nquit\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(cmds))
    rc = app_mod.main([
        "--config", str(tiny_config), "--interactive",
        "--out", str(tmp_path / "out"), "--deterministic",
    ])
    assert rc == 0
    text = capsys.readouterr().out
    assert "unknown command: bogus" in text
    assert "rays_per_s" in text
    assert list(save_dir.glob("*.png"))


def test_interactive_mouse_and_wheel(tiny_config, tmp_path, monkeypatch, capsys):
    """The pixel-delta input path (controls.cpp:167-215): mouse deltas x
    mouse_sensitivity drive fi/te, wheel x wheel_sensitivity drives psi,
    offsets beyond the border only recenter the cursor."""
    import io

    cmds = "capture\nmouse 10 5\nwheel 2\nmouse 9999 0\nquit\n"
    monkeypatch.setattr("sys.stdin", io.StringIO(cmds))
    rc = app_mod.main([
        "--config", str(tiny_config), "--interactive",
        "--out", str(tmp_path / "out"), "--deterministic",
    ])
    assert rc == 0
    assert "cursor recentered" in capsys.readouterr().out


def test_mouse_sensitivity_maps_pixels_to_radians(tiny_config):
    app = AppConfig.load(tiny_config)
    eng = app_mod.build_engine(app, deterministic=True)
    fi0, te0 = float(eng.angles.fi), float(eng.angles.te)
    assert eng.mouse_moved(10, -4)
    # dfi = dx * mouse_sensitivity (controls.cpp:179), dte = dy * sens.
    np.testing.assert_allclose(float(eng.angles.fi) - fi0,
                               10 * app.controls.mouse_sensitivity, atol=1e-6)
    np.testing.assert_allclose(float(eng.angles.te) - te0,
                               -4 * app.controls.mouse_sensitivity, atol=1e-6)
    psi0 = float(eng.angles.psi)
    eng.wheel_scrolled(3.0)
    np.testing.assert_allclose(float(eng.angles.psi) - psi0,
                               3.0 * app.controls.wheel_sensitivity, atol=1e-6)
    # border: max_mouse_offset = max(min(48, 29) - 15, 50) = 50
    assert eng.max_mouse_offset == 50
    fi1 = float(eng.angles.fi)
    assert not eng.mouse_moved(51, 0)  # beyond the border: recenter only
    assert float(eng.angles.fi) == fi1


def test_checkpoint_roundtrip(tmp_path):
    state = {
        "accum": np.arange(12, dtype=np.float32).reshape(2, 2, 3),
        "frame_number": np.int32(7),
    }
    path = tmp_path / "ckpt"
    checkpoint.save(path, state)
    got = checkpoint.restore(path, state)
    np.testing.assert_array_equal(np.asarray(got["accum"]), state["accum"])
    assert int(got["frame_number"]) == 7


def test_write_png_roundtrip(tmp_path):
    img = np.random.default_rng(0).random((5, 9, 3)).astype(np.float32)
    p = tmp_path / "x.png"
    write_png(p, img)
    w, h, data = read_png_header(p)
    assert (w, h) == (9, 5)
    # decode IDAT and compare pixels (filter 0 per row)
    idat_off = data.index(b"IDAT") + 4
    idat_len = struct.unpack(">I", data[data.index(b"IDAT") - 4:data.index(b"IDAT")])[0]
    raw = zlib.decompress(data[idat_off:idat_off + idat_len])
    rows = np.frombuffer(raw, np.uint8).reshape(5, 1 + 9 * 3)
    assert (rows[:, 0] == 0).all()
    px = rows[:, 1:].reshape(5, 9, 3)
    want = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(px, want)


def test_meter_counts_rays():
    m = Meter()
    with m.measure(1000) as h:
        h["result"] = np.zeros(3)
    assert m.stats.frames == 1 and m.stats.rays == 1000
    payload = json.loads(m.stats.as_json())
    assert payload["frames"] == 1 and payload["rays_per_s"] > 0


def test_checkpoint_resume_continues_exactly(tiny_config, tmp_path):
    """Engine checkpoint/resume: a saved run resumed in a fresh process
    state continues bit-identically to the uninterrupted run
    (deterministic seed sequence is replayed)."""
    app = AppConfig.load(tiny_config)
    ref = app_mod.build_engine(app, deterministic=True)
    ref.run(5)
    ref_acc = np.asarray(ref.accum)

    a = app_mod.build_engine(app, deterministic=True)
    a.run(3)
    ckpt = tmp_path / "state"
    a.save_checkpoint(ckpt)

    b = app_mod.build_engine(app, deterministic=True)
    b.load_checkpoint(ckpt)
    assert b.frame_number == a.frame_number and b.seed == a.seed
    b.run(2)
    np.testing.assert_array_equal(np.asarray(b.accum), ref_acc)


def test_checkpoint_cli_roundtrip(tiny_config, tmp_path):
    out = tmp_path / "out"
    state = tmp_path / "state"
    rc = app_mod.main([
        "--config", str(tiny_config), "--frames", "2", "--out", str(out),
        "--deterministic", "--save-state", str(state),
    ])
    assert rc == 0
    rc = app_mod.main([
        "--config", str(tiny_config), "--frames", "1", "--out", str(out),
        "--deterministic", "--load-state", str(state),
    ])
    assert rc == 0


def test_window_layout_reference_defaults(tiny_config):
    """Placement math (three_window_group.cpp:18-36) at the reference's
    default sizes on a 1920x1080 desktop: multiplier 1, main centered,
    additional row below."""
    cfg_text = (
        TINY_CONFIG
        .replace("show_additional_windows = false", "show_additional_windows = true")
        .replace("window.main.width = 96", "window.main.width = 850")
        .replace("window.main.cell_size = 4", "window.main.cell_size = 7")
        .replace("window.additional.width = 60", "window.additional.width = 600")
    )
    app = AppConfig.from_properties(
        __import__("fourd_ray_tracing_tpu.utils.config", fromlist=["Properties"])
        .Properties(dict(
            (k.strip(), v.split("#")[0].strip())
            for line in cfg_text.splitlines()
            if "=" in line
            for k, _, v in [line.partition("=")]
        ))
    )
    lay = app_mod.window_layout(app)
    # usable height = 1080 - 60 - 37 = 983; heights: main 525, add 370.
    assert lay["multiplier"] == 1.0
    assert lay["yxz"]["pos"] == [(1920 - 850) // 2, (983 - 525 - 370) // 3]
    assert lay["ywz"]["size"] == [600, 370]
    # small screens scale placement only, never render resolution
    small = AppConfig(**{**app.__dict__,
                         "screen": type(app.screen)(width=800, height=600)})
    lay2 = app_mod.window_layout(small)
    assert lay2["multiplier"] < 1.0
    assert app_mod.build_engine(small, deterministic=True).cfg.width == 121


def test_fps_overlay_burns_pixels():
    from fourd_ray_tracing_tpu.utils.overlay import draw_fps

    img = np.zeros((40, 80, 3), np.float32)
    out = draw_fps(img, 59.9, text_size=24)
    assert out.shape == img.shape
    assert out.max() == 1.0          # white glyph pixels
    assert (img == 0).all()          # input untouched
    assert (out > 0.5).sum() > 40    # a readable amount of text


def test_main_with_fps_overlay_and_layout(tiny_config, tmp_path):
    out = tmp_path / "out"
    rc = app_mod.main([
        "--config", str(tiny_config), "--frames", "1", "--out", str(out),
        "--deterministic", "--fps-overlay",
    ])
    assert rc == 0
    assert (out / "layout.json").exists()
    import json as _json

    lay = _json.loads((out / "layout.json").read_text())
    assert "yxz" in lay and "multiplier" in lay


def test_mouse_capture_state_machine(tiny_config, tmp_path, monkeypatch, capsys):
    """Capture gating (controls.cpp:194-205 + main.cpp:85): rendering,
    movement and mouse-look run only while the cursor is captured; the
    wheel rotates psi (and resets accumulation) even uncaptured but
    renders nothing; Escape releases capture again."""
    import io

    cmds = (
        "frames 3\n"        # uncaptured: ignored, nothing renders
        "mouse 10 5\n"      # uncaptured: ignored
        "wheel 2\n"         # uncaptured: psi rotates, NO render
        "capture\n"
        "frames 2\n"        # captured: renders
        "escape\n"
        "frames 5\n"        # released again: ignored
        "quit\n"
    )
    monkeypatch.setattr("sys.stdin", io.StringIO(cmds))
    captured_engines = {}
    orig_build = app_mod.build_engine

    def spy_build(app, deterministic=False):
        eng = orig_build(app, deterministic=deterministic)
        captured_engines["eng"] = eng
        return eng

    monkeypatch.setattr(app_mod, "build_engine", spy_build)
    rc = app_mod.main([
        "--config", str(tiny_config), "--interactive",
        "--out", str(tmp_path / "out"), "--deterministic",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "frames ignored: cursor not captured" in out
    assert "mouse ignored: cursor not captured" in out
    assert "cursor captured" in out
    assert "cursor released" in out
    # Only the 2 captured frames rendered; the wheel reset frame_number
    # to 1 before capture, so after 2 frames the counter reads 3.
    assert captured_engines["eng"].frame_number == 3


def test_capture_fps_overlay_suppression():
    """mouseJustHidden (main.cpp:97-102): the FIRST rendered frame after
    capture suppresses the FPS overlay; the next frame restores it."""
    cap = app_mod.CaptureState()
    assert not cap.captured
    cap.capture()
    assert cap.captured and cap.fps_suppress
    cap.frame_rendered()
    assert not cap.fps_suppress
    # Re-capturing while already captured does NOT re-arm suppression
    # (controls.cpp:195 arms mouseJustHidden only when !mouseHidden).
    cap.capture()
    assert not cap.fps_suppress
    cap.release()
    cap.capture()
    assert cap.fps_suppress


def test_live_preview_server(tiny_config, tmp_path):
    """--serve analogue: the PreviewServer streams the
    progressive accumulation over HTTP — index page lists every window,
    /frame.png is a valid PNG of the current buffer, and /stream yields
    multipart/x-mixed-replace PNG parts."""
    import urllib.request

    from fourd_ray_tracing_tpu.app import build_engine, make_preview

    app = AppConfig.load(tiny_config)
    engine = build_engine(app, deterministic=True)
    engine.step_frame()
    server = make_preview(engine, port=0, fps=30.0)
    try:
        base = server.url
        html = urllib.request.urlopen(base, timeout=10).read().decode()
        assert "/stream?view=yxz" in html
        png = urllib.request.urlopen(base + "frame.png?view=yxz",
                                     timeout=10).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        w, h = struct.unpack(">II", png[16:24])
        assert (w, h) == (24, 14)
        # One multipart chunk from the live stream.
        resp = urllib.request.urlopen(base + "stream?view=yxz", timeout=10)
        assert "multipart/x-mixed-replace" in resp.headers["Content-Type"]
        head = resp.read(64)
        assert b"--frame" in head and b"image/png" in head
        resp.close()
    finally:
        server.close()


def test_interactive_serve_flag(tiny_config, tmp_path, monkeypatch, capsys):
    """--interactive --serve 0 prints the preview URL and still renders."""
    import io

    monkeypatch.setattr("sys.stdin", io.StringIO("capture\nframes 1\nquit\n"))
    rc = app_mod.main([
        "--config", str(tiny_config), "--interactive", "--deterministic",
        "--out", str(tmp_path / "o"), "--serve", "0",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "live preview at http://" in out


@pytest.mark.slow
def test_browser_command_channel(tiny_config, tmp_path):
    """The preview page's command channel (POST /cmd): a subprocess app
    with stdin at EOF is driven entirely over HTTP — capture, move,
    release, quit — exactly like the page's JavaScript does."""
    import socket
    import subprocess
    import sys as _sys
    import time
    import urllib.request
    from pathlib import Path as _P

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = _P(__file__).resolve().parent.parent
    proc = subprocess.Popen(
        [_sys.executable, "-m", "fourd_ray_tracing_tpu",
         "--config", str(tiny_config), "--interactive", "--deterministic",
         "--serve", str(port), "--out", str(tmp_path / "o")],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=repo,
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"},
    )
    base = f"http://127.0.0.1:{port}/"
    try:
        for _ in range(150):  # wait for the server (imports + jit warmup)
            try:
                urllib.request.urlopen(base, timeout=1)
                break
            except Exception:
                time.sleep(0.2)
                assert proc.poll() is None, proc.stdout.read()[-2000:]

        def post(line):
            req = urllib.request.Request(
                base + "cmd", data=line.encode(), method="POST"
            )
            assert urllib.request.urlopen(req, timeout=10).status == 204

        post("capture")
        post("w 0.1")
        post("escape")
        post("quit")
        out, _ = proc.communicate(timeout=180)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-2000:]
    assert "cursor captured" in out and "cursor released" in out


def test_checkpoint_structure_mismatch_is_actionable(tmp_path):
    """Restoring into a differently-shaped pytree raises a clear
    ValueError naming the fingerprints (not a misassigned restore)."""
    import pytest as _pytest

    state = {"a": np.arange(4, dtype=np.float32), "b": np.float32(2.0)}
    path = tmp_path / "ck"
    checkpoint.save(path, state)
    wrong = {"a": np.arange(5, dtype=np.float32), "b": np.float32(2.0)}
    with _pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(path, wrong)
    # matching structure still round-trips
    got = checkpoint.restore(path, state)
    np.testing.assert_array_equal(got["a"], state["a"])


def test_packed_train_state_checkpoint_roundtrip(tmp_path):
    """save/restore_train_state resumes the packed production loop
    (diff.make_packed_train_step) exactly: a resumed run's next step
    equals the uninterrupted run's."""
    import optax

    import jax.numpy as jnp

    from fourd_ray_tracing_tpu import camera as cam
    from fourd_ray_tracing_tpu.diff import make_packed_train_step
    from fourd_ray_tracing_tpu.models import library
    from fourd_ray_tracing_tpu.models.renderer import RenderConfig
    from fourd_ray_tracing_tpu.ops.vec4 import Vec4

    scene0 = library.sphere_plane_light()
    cfg = RenderConfig(width=16, height=8, samples=2, reflections_amount=1,
                       rng_mode="per_sample")
    camera = cam.camera_from_state(
        Vec4.of(0.0, -2.0, 0.0, 0.0),
        cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)),
        1.5, 2.0,
    )
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    opt = optax.adam(1e-2)
    step, init, _ = make_packed_train_step(cfg, opt, camera, scene0)

    vec, ost = init(scene0)
    for i in range(2):
        vec, ost, _ = step(vec, ost, np.uint32(i + 1), target)
    checkpoint.save_train_state(tmp_path / "train", vec, ost, step=2)

    vec_r, ost_r, n = checkpoint.restore_train_state(
        tmp_path / "train", *init(scene0)
    )
    assert n == 2
    vec_a, _, loss_a = step(vec, ost, np.uint32(3), target)
    vec_b, _, loss_b = step(vec_r, ost_r, np.uint32(3), target)
    assert float(loss_a) == float(loss_b)
    np.testing.assert_array_equal(np.asarray(vec_a), np.asarray(vec_b))
