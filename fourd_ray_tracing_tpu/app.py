"""Application driver: config -> engine -> frames -> PNG "windows".

The analogue of the reference app layer (src/main.cpp:56-115
+ src/windows/): loads a properties file (same keys as the reference's
executable/properties.txt), builds the scene and camera, steps the
progressive-accumulation frame loop, and presents frames as PNG files —
one per "window" (main YXZ section, plus the two additional YWZ/YXW
sections when show_additional_windows is true, windows selected exactly
like main.cpp:57-68).

Per-window resolutions (windows.cpp:6-13, 24-28): the main window
renders at window.main cells (850/7 -> 121x75 by default) and the two
additional windows at window.additional cells (600/10 -> 60x37) — two
launches per frame, the additional views batched into one. PNGs are
written at cell resolution; --upscale replicates the sprite blit
(windows.cpp:33), scaling each PNG by its window's cell_size.

Interactive mode reads commands from stdin (the headless stand-in for
mouse capture + WASD, controls.cpp:167-215):

    w/s/a/d/space/c/e/q [seconds]   move (default 0.25 s)
    mouse <dx> <dy>                 mouse-look, PIXEL deltas (dy = up);
                                    scaled by mouse_sensitivity, offsets
                                    beyond the border only recenter
    wheel <delta>                   wheel clicks -> psi x wheel_sensitivity
    look <dfi> <dte> [dpsi]         rotate (raw radians)
    frames <n>                      render n frames (accumulating)
    save [path]                     write current windows to PNG
    stats                           print rays/s + fps counters
    quit
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import jax
import numpy as np

from fourd_ray_tracing_tpu import camera as cam
from fourd_ray_tracing_tpu.engine import RenderEngine
from fourd_ray_tracing_tpu.models import library
from fourd_ray_tracing_tpu.models.renderer import RenderConfig
from fourd_ray_tracing_tpu.ops.vec4 import Vec4
from fourd_ray_tracing_tpu.utils.compile_cache import setup_compile_cache
from fourd_ray_tracing_tpu.utils.config import AppConfig
from fourd_ray_tracing_tpu.utils.logging import log0
from fourd_ray_tracing_tpu.utils.image import write_png
from fourd_ray_tracing_tpu.utils.profiling import Meter

KEYMAP = {
    "w": cam.MoveKeys(forward=True),
    "s": cam.MoveKeys(back=True),
    "a": cam.MoveKeys(left=True),
    "d": cam.MoveKeys(right=True),
    "space": cam.MoveKeys(top=True),
    "c": cam.MoveKeys(down=True),
    "e": cam.MoveKeys(w_pos=True),
    "q": cam.MoveKeys(w_neg=True),
}


def build_engine(app: AppConfig, deterministic: bool = False,
                 impl: str = "auto", interpret: bool = False) -> RenderEngine:
    """Engine from an AppConfig (initControls + initShader analogue).
    ``impl`` and ``interpret`` as in `RenderEngine`.

    With show_additional_windows, the YWZ/YXW sections render as a
    SECOND view group at window.additional's cell resolution
    (three_window_group.cpp:42-46 + windows.cpp:6-13) instead of
    inheriting the main window's."""
    scene = library.SCENES[app.scene]()
    win = app.main_window

    def window_cfg(w):
        return RenderConfig(
            width=w.cells_width,
            height=w.cells_height,
            samples=app.samples,
            reflections_amount=app.reflections_amount,
            small_indent=app.small_indent,
            light_coefficient=app.light_to_color_conversion_coefficient,
            rng_mode="per_sample",
        )

    cfg = window_cfg(win)
    additional = None
    if app.show_additional_windows:
        additional = (window_cfg(app.additional_window), ("ywz", "yxw"))
    c = app.camera
    psi_constraint = None
    if app.controls.constrain_psi_range:
        psi_constraint = (
            float(np.radians(c.psi_deg)),
            float(np.radians(app.controls.psi_range_radius_deg)),
        )
    # maxMouseOffset = max(min(halfW, halfH) - border, 50) over the MAIN
    # window's pixel size (controls.cpp:145).
    half_w = win.cells_width * win.cell_size // 2
    half_h = win.cells_height * win.cell_size // 2
    max_mouse_offset = max(
        min(half_w, half_h) - app.controls.mouse_border_width, 50
    )
    return RenderEngine(
        scene,
        cfg,
        focus=Vec4.of(c.x, c.y, c.z, c.w),
        angles=cam.CameraAngles(
            np.float32(np.radians(c.fi_deg)),
            np.float32(np.radians(c.te_deg)),
            np.float32(np.radians(c.psi_deg)),
        ),
        focus_to_matrix_distance=c.focus_to_matrix_distance,
        matrix_height=c.matrix_height,
        views=("yxz",),
        movement_speed=app.controls.movement_speed,
        psi_constraint=psi_constraint,
        deterministic=deterministic,
        additional=additional,
        mouse_sensitivity=app.controls.mouse_sensitivity,
        wheel_sensitivity=app.controls.wheel_sensitivity,
        max_mouse_offset=max_mouse_offset,
        impl=impl,
        interpret=interpret,
    )


def window_layout(app: AppConfig) -> dict:
    """Window placement on the (virtual) desktop — the headless record
    of scaleWindows/setWindowPositions (three_window_group.cpp:18-36,
    single_window_group.cpp:15-26): the scale multiplier shrinks windows
    that don't fit the screen, indents center them.

    Reference quirk preserved deliberately: the C++ member-init order
    constructs the CellsWindows (and hence the CELL/render resolution)
    BEFORE scaleWindows() mutates the params, so scaling affects ONLY the
    placement math — never the render resolution. We reproduce exactly
    that: build_engine derives resolutions from the unscaled configs.
    """
    scr = app.screen
    sw, sh = scr.width, scr.usable_height
    main = app.main_window
    if not app.show_additional_windows:
        mult = min(1.0, sh / main.height, sw / main.width)
        w, h = int(main.width * mult), int(main.height * mult)
        return {
            "multiplier": mult,
            "yxz": {"pos": [(sw - w) // 2, (sh - h) // 2], "size": [w, h]},
        }
    add = app.additional_window
    mult = min(1.0, sh / (main.height + add.height), sw / 2 / add.width,
               sw / main.width)
    mw, mh = int(main.width * mult), int(main.height * mult)
    aw, ah = int(add.width * mult), int(add.height * mult)
    indent_x = (sw - aw * 2) // 3
    indent_y = (sh - mh - ah) // 3
    add_y = mh + scr.window_title_height + indent_y * 2
    return {
        "multiplier": mult,
        "yxz": {"pos": [(sw - mw) // 2, indent_y], "size": [mw, mh]},
        "ywz": {"pos": [indent_x, add_y], "size": [aw, ah]},
        "yxw": {"pos": [aw + indent_x * 2, add_y], "size": [aw, ah]},
    }


def save_windows(
    engine: RenderEngine, out_dir: Path, tag: str = "", upscale: dict | None = None,
    fps: float | None = None, text_size: int = 24,
) -> list:
    """Write one PNG per view window (the display() analogue).

    ``upscale``: optional {view: cell_size} — replicate each pixel
    cell_size x cell_size like the reference's sprite blit
    (windows.cpp:33, sprite.setScale(cellSize, cellSize)).

    Host 0 only under multi-host (SURVEY §5): N hosts writing the same
    files to a shared filesystem would race."""
    import jax

    if jax.process_index() != 0:
        return []
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for k, (view, img) in enumerate(engine.windows()):
        if fps is not None and k == 0:
            # FPS overlay on the main window only (main.cpp:101, drawFPS)
            from fourd_ray_tracing_tpu.utils.overlay import draw_fps

            img = draw_fps(img, fps, text_size)
        s = (upscale or {}).get(view, 1)
        if s > 1:
            img = np.repeat(np.repeat(img, s, axis=0), s, axis=1)
        p = out_dir / f"{view}{tag}.png"
        write_png(p, img)
        paths.append(p)
    return paths


def run_frames(engine: RenderEngine, meter: Meter, n: int, quiet=False,
               min_frame_seconds: float = 0.0):
    """Step n frames; ``min_frame_seconds`` paces the loop like the
    reference's framerate cap (windows.cpp:30 setFramerateLimit(maxFPS)).

    Unpaced multi-frame runs (max_fps disabled) batch ALL n frames into
    one dispatch per view group (engine.step_frames): the idle
    progressive-accumulation path is dispatch-bound per frame otherwise,
    and the batched sequence is bit-identical to n single steps."""
    if n > 1 and min_frame_seconds <= 0.0:
        with meter.measure(engine.rays_per_frame() * n, frames=n) as h:
            h["result"] = engine.step_frames(n)
    else:
        for _ in range(n):
            t0 = time.perf_counter()
            with meter.measure(engine.rays_per_frame()) as h:
                h["result"] = engine.step_frame()
            leftover = min_frame_seconds - (time.perf_counter() - t0)
            if leftover > 0:
                time.sleep(leftover)
    if not quiet:
        log0(meter.stats.as_json())


class CaptureState:
    """Mouse-capture state machine (controls.cpp:194-205 + main.cpp:85,
    97-102), headless:

    * the app starts UNCAPTURED; rendering, movement and mouse-look are
      gated on capture exactly like the reference frame loop runs only
      `if (mouseHidden)` (main.cpp:85);
    * `capture` = MouseButtonPressed (controls.cpp:194-198): hides the
      cursor, captures, and arms `fps_suppress` (mouseJustHidden) so the
      FPS overlay skips the FIRST rendered frame after capture
      (main.cpp:97-102 — the frame timer just restarted, its reading
      would be garbage);
    * `escape` = Escape key (controls.cpp:202-205): releases;
    * the wheel rotates psi and resets accumulation even while
      UNCAPTURED — the reference's MouseWheelScrolled case has no
      mouseHidden check (controls.cpp:186-191) — but still renders
      nothing until capture.
    """

    def __init__(self):
        self.captured = False
        self.fps_suppress = False  # mouseJustHidden (main.cpp:98-99)

    def capture(self):
        if not self.captured:
            self.fps_suppress = True  # (controls.cpp:195)
        self.captured = True

    def release(self):
        self.captured = False

    def frame_rendered(self):
        """The first rendered frame after capture consumes the FPS
        suppression (main.cpp:98-99: mouseJustHidden = false)."""
        self.fps_suppress = False


def make_preview(engine: RenderEngine, upscale: dict | None = None,
                 cap: "CaptureState | None" = None, meter: Meter | None = None,
                 port: int = 0, fps: float = 10.0, text_size: int = 24,
                 on_command=None):
    """Live HTTP preview of every window (utils/viewer.PreviewServer —
    the reference's on-screen display, main.cpp:79-106, as a stream).
    The callback snapshots the newest accumulation buffer per request
    (never blocks the render loop) and applies the same presentation as
    the PNG path: upscale sprite blit + capture-gated FPS overlay on the
    main window only. Host 0 only (like save_windows)."""
    import jax

    if jax.process_index() != 0:
        return None
    from fourd_ray_tracing_tpu.utils.image import to_uint8
    from fourd_ray_tracing_tpu.utils.viewer import PreviewServer

    views = [v for g in engine.groups for v in g.views]
    last_good: dict = {}

    def _snapshot(g):
        # The render loop DONATES each group's accumulation buffer to
        # the next jitted step (engine._ViewGroup), so a server thread's
        # d2h copy can race the donation and raise "Array has been
        # deleted". Grab the newest reference and retry; fall back to
        # the last good frame if the race keeps winning.
        for _ in range(3):
            try:
                return np.asarray(g.accum)
            except Exception:
                continue
        return None

    def get_frame(view: str) -> np.ndarray:
        for g in engine.groups:
            if view in g.views:
                acc = _snapshot(g)
                if acc is None:
                    if view in last_good:
                        return last_good[view]
                    acc = np.zeros(
                        ((len(g.views),) if len(g.views) > 1 else ())
                        + (g.cfg.height, g.cfg.width, 3), np.float32,
                    )
                img = acc if acc.ndim == 3 else acc[g.views.index(view)]
                break
        else:  # pragma: no cover - PreviewServer validates views
            raise KeyError(view)
        if (view == views[0] and cap is not None and meter is not None
                and cap.captured and not cap.fps_suppress
                and meter.stats.seconds > 0):
            from fourd_ray_tracing_tpu.utils.overlay import draw_fps

            img = draw_fps(img, meter.stats.frames / meter.stats.seconds,
                           text_size)
        s = (upscale or {}).get(view, 1)
        if s > 1:
            img = np.repeat(np.repeat(img, s, axis=0), s, axis=1)
        out = to_uint8(img)
        last_good[view] = out
        return out

    return PreviewServer(get_frame, views=views, port=port, fps=fps,
                         on_command=on_command)


def interactive_loop(
    engine: RenderEngine, out_dir: Path, upscale: dict | None = None,
    min_frame_seconds: float = 0.0, serve_port: int | None = None,
    serve_fps: float = 10.0,
) -> None:
    """Interactive session. Commands arrive on a queue fed by BOTH stdin
    (a reader thread) and, with ``serve_port``, the preview page's
    browser input (utils/viewer.py POST /cmd) — all engine stepping
    stays in THIS thread. While the preview is live and the cursor is
    captured, the loop free-runs the progressive accumulation between
    commands (the reference's `while window.isOpen()` render loop,
    main.cpp:79-106, paced by max_fps); without a preview it blocks on
    the next command exactly like before. stdin EOF ends the session
    unless a preview is serving (browser-only sessions: pipe /dev/null
    and drive everything from the page)."""
    import queue
    import threading

    meter = Meter()
    cap = CaptureState()
    cmds: "queue.Queue" = queue.Queue()
    _EOF = object()

    def stdin_reader():
        for line in sys.stdin:
            cmds.put(line)
        cmds.put(_EOF)

    threading.Thread(target=stdin_reader, daemon=True).start()
    preview = None
    if serve_port is not None:
        preview = make_preview(engine, upscale, cap, meter,
                               port=serve_port, fps=serve_fps,
                               on_command=cmds.put)
        if preview is not None:
            log0(f"live preview at {preview.url}")

    def frames(n):
        run_frames(engine, meter, n, min_frame_seconds=min_frame_seconds)
        if n > 0:
            cap.frame_rendered()

    def gated(what: str) -> bool:
        """True when rendering may proceed; the reference renders/moves
        only while the cursor is captured (main.cpp:85)."""
        if not cap.captured:
            log0(f"{what} ignored: cursor not captured (use 'capture')")
            return False
        return True

    log0(
        "interactive; commands: capture, escape, w/s/a/d/space/c/e/q, "
        "mouse, wheel, look, frames, save, stats, quit"
    )
    idle = 0
    while True:
        if preview is not None and cap.captured:
            # Captured + serving: free-run the accumulation between
            # commands so the browser watches it converge live. After a
            # few single responsive frames, idle stretches batch 8
            # frames per dispatch (engine.step_frames — bit-identical,
            # one launch), so per-frame dispatch overhead does not cap
            # the free-running frame rate.
            try:
                line = cmds.get_nowait()
                idle = 0
            except queue.Empty:
                idle += 1
                n = 8 if idle > 8 else 1
                t0 = time.perf_counter()
                with meter.measure(engine.rays_per_frame() * n, frames=n) as h:
                    h["result"] = engine.step_frames(n)
                cap.frame_rendered()
                leftover = min_frame_seconds * n - (time.perf_counter() - t0)
                if leftover > 0:
                    time.sleep(leftover)
                continue
        else:
            line = cmds.get()
            idle = 0
        if line is _EOF:
            if preview is None:
                break
            continue  # browser can still drive the session
        parts = line.strip().split()
        if not parts:
            continue
        cmd, *args = parts
        if cmd == "quit":
            break
        elif cmd == "capture":
            cap.capture()
            log0("cursor captured (hidden)")
        elif cmd == "escape":
            cap.release()
            log0("cursor released")
        elif cmd in KEYMAP:
            if not gated("move"):
                continue
            seconds = float(args[0]) if args else 0.25
            engine.move(KEYMAP[cmd], seconds)
            frames(1)
        elif cmd == "mouse":
            # MouseMoved is processed only while captured (controls.cpp:173).
            if not gated("mouse"):
                continue
            dx = int(args[0]) if len(args) > 0 else 0
            dy = int(args[1]) if len(args) > 1 else 0
            if engine.mouse_moved(dx, dy):
                frames(1)
            else:
                log0("cursor recentered")
        elif cmd == "wheel":
            # psi rotates + accumulation resets even UNCAPTURED
            # (controls.cpp:186-191 has no mouseHidden check) …
            engine.wheel_scrolled(float(args[0]) if args else 1.0)
            # … but nothing renders until capture (main.cpp:85).
            if cap.captured:
                frames(1)
        elif cmd == "look":
            if not gated("look"):
                continue
            d_fi = float(args[0]) if len(args) > 0 else 0.0
            d_te = float(args[1]) if len(args) > 1 else 0.0
            d_psi = float(args[2]) if len(args) > 2 else 0.0
            engine.rotate(d_fi=d_fi, d_te=d_te, d_psi=d_psi)
            frames(1)
        elif cmd == "frames":
            if not gated("frames"):
                continue
            frames(int(args[0]) if args else 1)
        elif cmd == "save":
            target = Path(args[0]) if args else out_dir
            # FPS overlay follows the reference's drawFPS gating: only
            # while captured, and not on the first frame after capture.
            fps = None
            if cap.captured and not cap.fps_suppress and meter.stats.seconds > 0:
                fps = meter.stats.frames / meter.stats.seconds
            for p in save_windows(engine, target, upscale=upscale, fps=fps):
                log0(f"wrote {p}")
        elif cmd == "stats":
            log0(meter.stats.as_json())
        else:
            log0(f"unknown command: {cmd}")
    if preview is not None:
        preview.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="configs/properties.txt")
    ap.add_argument("--scene", default=None, help="override config scene key")
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default="out")
    ap.add_argument("--interactive", action="store_true")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--load-state", default=None,
                    help="resume accumulation/camera from a checkpoint dir")
    ap.add_argument("--save-state", default=None,
                    help="write engine state to a checkpoint dir at exit")
    ap.add_argument("--fps-overlay", action="store_true",
                    help="burn the FPS counter into the main window PNG "
                    "(drawFPS analogue, windows.cpp:49-53)")
    ap.add_argument(
        "--upscale", action="store_true",
        help="scale PNGs by each window's cell_size (the sprite blit, "
        "windows.cpp:33)",
    )
    ap.add_argument(
        "--serve", type=int, default=None, metavar="PORT",
        help="serve a live HTTP preview of every window (0 = random "
        "port); the headless analogue of the reference's on-screen "
        "display (main.cpp:79-106)",
    )
    ap.add_argument("--serve-fps", type=float, default=10.0,
                    help="preview stream parts/second cap")
    ap.add_argument(
        "--precompile", action=argparse.BooleanOptionalAction, default=None,
        help="warm every step-size compile variant before the first "
        "frame so a live session never stalls on a compile "
        "mid-interaction (default: on when serving/interactive)",
    )
    args = ap.parse_args(argv)
    setup_compile_cache()

    app = AppConfig.load(args.config)
    if args.scene:
        app = type(app)(**{**app.__dict__, "scene": args.scene})
    engine = build_engine(app, deterministic=args.deterministic)
    if args.load_state:
        engine.load_checkpoint(args.load_state)
        log0(f"resumed from {args.load_state} at frame {engine.frame_number}")
    out_dir = Path(args.out)
    upscale = None
    if args.upscale:
        upscale = {"yxz": app.main_window.cell_size,
                   "ywz": app.additional_window.cell_size,
                   "yxw": app.additional_window.cell_size}

    res = [f"{g.cfg.width}x{g.cfg.height}:{','.join(g.views)}"
           for g in engine.groups]
    log0(
        f"scene={app.scene} windows={res} spp={engine.cfg.samples} "
        f"bounces={engine.cfg.reflections_amount} device={jax.devices()[0]}"
    )
    # Warm-start: default ON for any live session (interactive or
    # serving) — a fresh session otherwise pays up to len(STEP_CHUNKS)+1
    # compiles at unpredictable moments mid-interaction. The measured
    # warmup ~= time-to-first-frame.
    precompile = args.precompile
    if precompile is None:
        precompile = args.interactive or args.serve is not None
    if precompile:
        log0("precompiling step variants "
             f"(chunks {engine.STEP_CHUNKS} x {len(engine.groups)} groups)...")
        warm = engine.precompile()
        log0(f"precompile done in {warm:.1f}s — session is stall-free")

    if args.interactive:
        pace = 1.0 / app.max_fps if app.max_fps > 0 else 0.0
        interactive_loop(engine, out_dir, upscale=upscale,
                         min_frame_seconds=pace, serve_port=args.serve,
                         serve_fps=args.serve_fps)
        if args.save_state:
            engine.save_checkpoint(args.save_state)
            log0(f"saved state to {args.save_state}")
        return 0

    meter = Meter()
    preview = None
    if args.serve is not None:
        preview = make_preview(engine, upscale, port=args.serve,
                               fps=args.serve_fps, text_size=app.text.size)
        if preview is not None:
            log0(f"live preview at {preview.url}")
    t0 = time.perf_counter()
    run_frames(engine, meter, args.frames)
    fps = meter.stats.frames / meter.stats.seconds if args.fps_overlay else None
    for p in save_windows(engine, out_dir, upscale=upscale, fps=fps,
                          text_size=app.text.size):
        log0(f"wrote {p}")
    if jax.process_index() == 0:
        import json as _json

        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "layout.json").write_text(_json.dumps(window_layout(app), indent=1))
    if args.save_state:
        engine.save_checkpoint(args.save_state)
        log0(f"saved state to {args.save_state}")
    log0(f"total {time.perf_counter() - t0:.2f}s")
    if preview is not None:
        preview.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
