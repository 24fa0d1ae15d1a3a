"""Live progressive-accumulation preview over HTTP.

The reference is an on-screen app: you WATCH the accumulation converge
in an SFML window at up to max_fps (src/main.cpp:79-106,
src/windows/windows.cpp:24-47). The accelerator host is headless, so the
presentation layer streams instead: `PreviewServer` serves

  /            a tiny HTML page showing the live stream(s), one <img>
               per window, placed with the window_layout proportions
  /stream?view=yxz
               a multipart/x-mixed-replace stream of PNG frames (the
               MJPEG pattern with lossless parts — every mainstream
               browser renders it) at up to ``fps`` parts/second
  /frame.png?view=yxz
               the current frame once (curl-able)
  POST /cmd    one interactive command line (the same grammar as the
               stdin loop: capture, escape, w/a/s/d/space/c/e/q,
               mouse DX DY, wheel D, frames N, …), forwarded to the
               app's command queue — the index page's JavaScript turns
               real browser input into these: click = mouse capture
               (Pointer Lock), Escape = release, WASD/Space/C/E/Q =
               movement, captured mouse movement = mouse-look, wheel =
               psi. The browser becomes the reference's interactive
               window (controls.cpp:167-215), steering AND watching.

The server owns NOTHING: it pulls frames through a ``get_frame(view)``
callback supplied by the app (which applies the upscale sprite blit and
the capture-gated FPS overlay exactly like the PNG path) and pushes
command lines through ``on_command`` (which must only ENQUEUE — the
render loop stays single-threaded in the app's main thread). Frames are
encoded per-connection at compress_level 1 — on a localhost stream
encode speed beats size.

stdlib-only (http.server + threading): nothing to install, works
through an SSH port-forward to the GPU host.
"""
from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Sequence
from urllib.parse import parse_qs, urlparse

import numpy as np

from fourd_ray_tracing_tpu.utils.image import encode_png

_PAGE = """<!doctype html>
<html><head><title>fourd_ray_tracing_tpu</title>
<style>body{{background:#111;color:#ddd;font:14px monospace;text-align:center}}
img{{image-rendering:pixelated;margin:6px;border:1px solid #333}}
#s{{color:#8a8}}</style>
</head><body><h3>fourd_ray_tracing_tpu &mdash; live</h3>
{imgs}
<p id="s">click the main window to capture the mouse (Esc releases);
WASD/Space/C move, E/Q slide along w, wheel rotates psi &mdash;
controls.cpp:167-215 in a browser</p>
<script>
const send = l => fetch('/cmd', {{method: 'POST', body: l}});
const img = document.querySelector('img');
let captured = false, dx = 0, dy = 0;
img.onclick = () => img.requestPointerLock();
document.addEventListener('pointerlockchange', () => {{
  captured = document.pointerLockElement === img;
  send(captured ? 'capture' : 'escape');
  document.getElementById('s').textContent =
    captured ? 'captured - Esc to release' : 'click the main window to capture';
}});
document.addEventListener('mousemove', e => {{
  if (captured) {{ dx += e.movementX; dy -= e.movementY; }}
}});
setInterval(() => {{
  if (captured && (dx || dy)) {{
    send(`mouse ${{dx}} ${{dy}}`); dx = 0; dy = 0;
  }}
}}, 60);
const keymap = {{w:'w', a:'a', s:'s', d:'d', ' ':'space', c:'c',
                e:'e', q:'q'}};
document.addEventListener('keydown', e => {{
  if (captured && keymap[e.key]) {{ send(keymap[e.key] + ' 0.1');
                                    e.preventDefault(); }}
}});
document.addEventListener('wheel', e => {{
  if (captured) send(`wheel ${{e.deltaY > 0 ? -1 : 1}}`);
}});
</script></body></html>"""


class PreviewServer:
    """Threaded HTTP preview. ``get_frame(view) -> (H, W, 3) uint8`` is
    called from server threads; it must be cheap and lock-free (snapshot
    the newest buffer, never block the render loop)."""

    def __init__(
        self,
        get_frame: Callable[[str], np.ndarray],
        views: Sequence[str] = ("yxz",),
        host: str = "127.0.0.1",
        port: int = 0,
        fps: float = 10.0,
        on_command: Callable[[str], None] | None = None,
    ):
        self._get_frame = get_frame
        self._on_command = on_command
        self.views = tuple(views)
        self.fps = float(fps)
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _view(self) -> str:
                q = parse_qs(urlparse(self.path).query)
                v = q.get("view", [outer.views[0]])[0]
                return v if v in outer.views else outer.views[0]

            def do_GET(self):  # noqa: N802 (stdlib API name)
                path = urlparse(self.path).path
                if path == "/":
                    imgs = "".join(
                        f'<img src="/stream?view={v}" alt="{v}" title="{v}">'
                        for v in outer.views
                    )
                    body = _PAGE.format(imgs=imgs).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/frame.png":
                    data = encode_png(outer._get_frame(self._view()),
                                      compress_level=1)
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(data)))
                    self.send_header("Cache-Control", "no-store")
                    self.end_headers()
                    self.wfile.write(data)
                elif path == "/stream":
                    view = self._view()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame",
                    )
                    self.end_headers()
                    delay = 1.0 / max(outer.fps, 0.1)
                    try:
                        while not outer._closed:
                            data = encode_png(outer._get_frame(view),
                                              compress_level=1)
                            self.wfile.write(
                                b"--frame\r\nContent-Type: image/png\r\n"
                                + f"Content-Length: {len(data)}\r\n\r\n".encode()
                            )
                            self.wfile.write(data)
                            self.wfile.write(b"\r\n")
                            self.wfile.flush()
                            time.sleep(delay)
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_error(404)

            def do_POST(self):  # noqa: N802 (stdlib API name)
                if urlparse(self.path).path != "/cmd" or outer._on_command is None:
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                if n > 1024:
                    # Reject instead of truncating: unread body bytes
                    # would desync keep-alive request parsing.
                    self.send_error(413)
                    return
                line = self.rfile.read(n).decode("utf-8", "replace")
                outer._on_command(line.strip()[:256])
                self.send_response(204)
                self.end_headers()

        self._closed = False
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    def close(self) -> None:
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
