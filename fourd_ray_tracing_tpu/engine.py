"""Frame-loop engine: seeds, progressive accumulation, camera state.

The equivalent of the reference app driver (src/main.cpp:56-115):

* per-frame seed: ``seed ^= generate_seed()`` (main.cpp:52-54, 86);
* ``part = 1/frame_number`` progressive blend while the camera is still
  (main.cpp:87, shader.frag:526-527);
* any camera rotation/movement resets frame_number to 1
  (controls.cpp:132, 181, 191);
* the accumulation buffer is donated to the jitted step, so XLA updates
  it in place — the explicit, race-free replacement for the reference's
  GL texture-feedback self-read (windows.cpp:42-45, flagged in SURVEY §5
  as undefined behavior NOT to replicate).

View groups (src/windows/three_window_group.cpp): the main window and
the additional windows render at DIFFERENT cell resolutions
(windows.cpp:6-13, 24-28: 850/7 -> 121x75 vs 600/10 -> 60x37). The
engine therefore owns a list of view groups — each a (config, views)
pair with its own accumulation buffer and jitted step; the two
additional views batch into ONE launch (a leading view axis), the main
view is its own launch. All groups share the camera, seed and
frame_number, exactly like the reference's three windows share one
shader state.

Camera state machine: when the native host layer builds
(native/controls.cc — the reference's camera layer is C++ too), the
interactive camera state lives in the C struct and rotations/movements
run through it; camera.py remains the traced/differentiable math and the
pure-Python fallback. Input mapping (controls.cpp:167-215): pixel
deltas x mouse_sensitivity, wheel clicks x wheel_sensitivity, offsets
beyond max_mouse_offset discarded (cursor recenter).
"""
from __future__ import annotations

import ctypes
import functools
import time
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from fourd_ray_tracing_tpu import camera as cam
from fourd_ray_tracing_tpu.models.renderer import (
    RenderConfig,
    accumulate,
    render_image,
)
from fourd_ray_tracing_tpu.models.scene import Scene
from fourd_ray_tracing_tpu.ops.vec4 import Vec4


IMPLS = ("pallas", "xla")


def resolve_impl(impl: str = "auto", platform: Optional[str] = None) -> str:
    """The forward render path: "pallas" (the Triton kernel,
    ops/pallas/megakernel.py) or "xla" (the jnp pipeline). "auto" picks
    the kernel on "gpu" and XLA on "cpu" (the kernel runs there only in
    the Pallas interpreter, far slower than XLA); any other platform has
    no tested path and raises."""
    if impl != "auto":
        if impl not in IMPLS:
            raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
        return impl
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no forward render path for platform {platform!r}")


def generate_seed(rng: np.random.Generator, wall_clock: bool = True) -> int:
    """Per-frame 32-bit seed; entropy from an RNG plus the wall clock,
    like main.cpp:52-54 (rand() xors + elapsed microseconds)."""
    s = int(rng.integers(0, 2**32))
    if wall_clock:
        s ^= time.monotonic_ns() // 1000 & 0xFFFFFFFF
    return s & 0xFFFFFFFF


class _ViewGroup:
    """One window group: views sharing a render resolution + accum."""

    def __init__(self, cfg: RenderConfig, views: Tuple[str, ...], render, scene):
        self.cfg = cfg
        self.views = views
        shape = (len(views), cfg.height, cfg.width, 3)
        if len(views) == 1:
            shape = shape[1:]
        self.accum = jnp.zeros(shape, jnp.float32)
        self._render = render

        def step(scene_, accum, camera, seed, part):
            frame = render(scene_, camera, cfg, seed)
            return accumulate(accum, frame, part)

        self._step = jax.jit(step, donate_argnums=(1,))

        # N accumulation frames per dispatch (idle-viewer batching): the
        # kernel renders all K seeds in ONE launch (grid frame axis),
        # then the K progressive blends run inside the same jit; the jnp
        # renderer loops the K seeds inside one jit instead (no host
        # dispatch between frames either way). Parts are computed on the
        # host exactly like step_frame's, so the accumulation sequence
        # is bit-identical to K single steps.
        seed_batch = getattr(render, "supports_seed_batch", False)

        def step_n(scene_, accum, camera, seeds, parts):
            if seed_batch:
                frames = render(scene_, camera, cfg, seeds)

                def body(k, acc):
                    return accumulate(acc, frames[k], parts[k])
            else:

                def body(k, acc):
                    img = render(scene_, camera, cfg, seeds[k])
                    return accumulate(acc, img, parts[k])

            return jax.lax.fori_loop(0, seeds.shape[0], body, accum)

        self._step_n = jax.jit(step_n, donate_argnums=(1,))

    def camera(self, engine: "RenderEngine") -> cam.Camera:
        orient = engine.orientation()
        mtr_h = jnp.float32(engine.matrix_height)
        if len(self.views) == 1:
            top, right = cam.view_basis(orient, self.views[0])
        else:
            top, right = cam.batched_view_bases(orient, self.views)
        return cam.Camera(
            focus=engine.focus,
            vec_to_mtr=orient.forward * jnp.float32(engine.focus_to_matrix_distance),
            top=top,
            right=right,
            mtr_width=mtr_h * cam.GOLDEN,
            mtr_height=mtr_h,
        )


class RenderEngine:
    """Owns camera state + per-group accumulation and steps frames.

    ``deterministic`` pins the seed sequence (no wall clock) so a frame
    sequence is reproducible from (scene, config, initial state).
    ``additional`` renders extra views at their OWN resolution:
    (RenderConfig, views) — the reference's additional-window group.
    """

    def __init__(
        self,
        scene: Scene,
        cfg: RenderConfig,
        focus: Vec4,
        angles: cam.CameraAngles,
        focus_to_matrix_distance: float = 1.5,
        matrix_height: float = 2.0,
        views: Sequence[str] = ("yxz",),
        movement_speed: float = 3.0,
        psi_constraint: Optional[tuple] = None,  # (center, radius) or None
        deterministic: bool = False,
        impl: str = "auto",  # "auto" | "pallas" | "xla" (resolve_impl)
        interpret: bool = False,  # kernel in the Pallas interpreter (CPU)
        additional: Optional[Tuple[RenderConfig, Sequence[str]]] = None,
        mouse_sensitivity: float = 0.005,
        wheel_sensitivity: float = 0.1,
        max_mouse_offset: Optional[int] = None,
        use_native_controls: str = "auto",  # "auto" | "native" | "python"
    ):
        self.scene = scene
        self.cfg = cfg
        self.views = tuple(views)
        self._cameras = None  # per-group cameras of the current state
        self.focus_to_matrix_distance = float(focus_to_matrix_distance)
        self.matrix_height = float(matrix_height)
        self.movement_speed = float(movement_speed)
        self.psi_constraint = psi_constraint
        self.mouse_sensitivity = float(mouse_sensitivity)
        self.wheel_sensitivity = float(wheel_sensitivity)
        self.max_mouse_offset = max_mouse_offset
        self.frame_number = 1
        self.seed = 0
        self._np_rng = np.random.default_rng(0 if deterministic else None)
        self._deterministic = deterministic
        self._rng_draws = 0  # for deterministic checkpoint/resume

        # --- camera state: native C struct when available ---------------
        self._native = None
        # Initial angles normalize like SphOrientation::init (controls.cpp:29-39).
        norm_angles = angles.normalized(*(psi_constraint or (None, None)))
        if use_native_controls in ("auto", "native"):
            try:
                from fourd_ray_tracing_tpu.native import binding

                self._native = binding.new_camera_state(
                    fi=float(norm_angles.fi), te=float(norm_angles.te),
                    psi=float(norm_angles.psi),
                    focus=tuple(float(np.asarray(c)) for c in focus),
                    psi_constraint=psi_constraint,
                )
                self._binding = binding
            except Exception:
                if use_native_controls == "native":
                    raise
                self._native = None
        if self._native is None:
            self.angles = norm_angles
            self.focus = focus

        impl = resolve_impl(impl)
        if impl == "pallas":
            from fourd_ray_tracing_tpu.ops.pallas.megakernel import (
                render_image_pallas,
                with_static_hints,
            )

            render = functools.partial(render_image_pallas, interpret=interpret)
            render.supports_seed_batch = True
            # Inside the jitted step the scene leaves are tracers and no
            # hint could derive: derive the static hints (hyperplane zero
            # components, wall pairs, axis alignment) from the CONCRETE
            # scene here, once, and bake them into the configs.
            cfg = self.cfg = with_static_hints(cfg, scene)
            if additional is not None:
                additional = (with_static_hints(additional[0], scene),
                              additional[1])
        else:
            render = render_image
        self.impl = impl

        self.groups: List[_ViewGroup] = [_ViewGroup(cfg, self.views, render, scene)]
        if additional is not None:
            add_cfg, add_views = additional
            self.groups.append(_ViewGroup(add_cfg, tuple(add_views), render, scene))

    # --- camera state machine (L3 analogue) ---------------------------

    @property
    def focus(self) -> Vec4:
        if self._native is not None:
            f = self._native.focus
            return Vec4.of(f[0], f[1], f[2], f[3])
        return self._focus

    @focus.setter
    def focus(self, v: Vec4):
        self._cameras = None
        if self._native is not None:
            for i, c in enumerate((v.x, v.y, v.z, v.w)):
                self._native.focus[i] = float(np.asarray(c))
        else:
            self._focus = v

    @property
    def angles(self) -> cam.CameraAngles:
        if self._native is not None:
            s = self._native
            return cam.CameraAngles(
                jnp.float32(s.fi), jnp.float32(s.te), jnp.float32(s.psi)
            )
        return self._angles

    @angles.setter
    def angles(self, a: cam.CameraAngles):
        self._cameras = None
        if self._native is not None:
            s = self._native
            s.fi, s.te, s.psi = float(a.fi), float(a.te), float(a.psi)
            self._binding.load().fourd_camera_update(ctypes.byref(s))
        else:
            self._angles = a

    def orientation(self) -> cam.Orientation:
        """Camera basis — straight from the native state machine when it
        drives the viewer, else derived from the Python angles."""
        if self._native is not None:
            s = self._native
            v = lambda f: Vec4.of(f[0], f[1], f[2], f[3])
            return cam.Orientation(
                v(s.forward), v(s.top), v(s.right), v(s.w_drct),
                v(s.h_forward), v(s.h_right), v(s.v_top),
            )
        return cam.orientation_from_angles(
            self._angles.fi, self._angles.te, self._angles.psi
        )

    def _camera(self) -> cam.Camera:
        return self.groups[0].camera(self)

    def _launch_cameras(self) -> List[cam.Camera]:
        """Each group's camera for the current camera state, built once:
        building one takes a few dozen small device operations, which
        cost more than a 1280x720 kernel frame, so frames accumulated
        while the camera is still reuse it. Every camera-state change
        clears it."""
        if self._cameras is None:
            self._cameras = [g.camera(self) for g in self.groups]
        return self._cameras

    def reset_accumulation(self):
        self.frame_number = 1

    def rotate(self, d_fi: float = 0.0, d_te: float = 0.0, d_psi: float = 0.0):
        """Mouse-look / wheel analogue (controls.cpp:173-191), in radians."""
        self._cameras = None
        if self._native is not None:
            self._binding.rotate(self._native, d_fi, d_te, d_psi)
        else:
            a = cam.CameraAngles(
                self._angles.fi + jnp.float32(d_fi),
                self._angles.te + jnp.float32(d_te),
                self._angles.psi + jnp.float32(d_psi),
            )
            self._angles = a.normalized(*(self.psi_constraint or (None, None)))
        self.reset_accumulation()

    def mouse_moved(self, dx: int, dy: int) -> bool:
        """Pixel-delta mouse look (controls.cpp:173-185): dx right, dy UP
        (the reference computes dy = halfH - y). Offsets beyond
        max_mouse_offset only recenter the cursor — no rotation. Returns
        True iff the camera rotated."""
        if self.max_mouse_offset is not None and (
            abs(dx) > self.max_mouse_offset or abs(dy) > self.max_mouse_offset
        ):
            return False
        if dx == 0 and dy == 0:
            return False
        self.rotate(
            d_fi=dx * self.mouse_sensitivity, d_te=dy * self.mouse_sensitivity
        )
        return True

    def wheel_scrolled(self, delta: float) -> None:
        """Vertical wheel -> psi (controls.cpp:187-191)."""
        self.rotate(d_psi=delta * self.wheel_sensitivity)

    def move(self, keys: cam.MoveKeys, seconds: float):
        """Keyboard movement (controls.cpp:118-134)."""
        if self._native is not None:
            from fourd_ray_tracing_tpu.native import binding as b

            mask = 0
            for flag, bit in (
                (keys.forward, b.KEY_FORWARD), (keys.back, b.KEY_BACK),
                (keys.right, b.KEY_RIGHT), (keys.left, b.KEY_LEFT),
                (keys.top, b.KEY_TOP), (keys.down, b.KEY_DOWN),
                (keys.w_pos, b.KEY_W_POS), (keys.w_neg, b.KEY_W_NEG),
            ):
                if flag:
                    mask |= bit
            moved = self._binding.move(
                self._native, mask, float(seconds), self.movement_speed
            )
            if moved:
                self._cameras = None
                self.reset_accumulation()
            return
        orient = cam.orientation_from_angles(
            self._angles.fi, self._angles.te, self._angles.psi
        )
        new_focus, moved = cam.move_focus(
            self.focus, orient, keys, jnp.float32(seconds),
            jnp.float32(self.movement_speed),
        )
        if bool(moved):
            self.focus = new_focus
            self.reset_accumulation()

    # --- frame step (L2 analogue) --------------------------------------

    @property
    def accum(self) -> jnp.ndarray:
        """Main group's accumulation buffer (compat accessor)."""
        return self.groups[0].accum

    def step_frame(self) -> jnp.ndarray:
        """Render one frame into every group's accumulation buffer;
        returns the main group's."""
        self.seed ^= generate_seed(self._np_rng, wall_clock=not self._deterministic)
        self._rng_draws += 1
        part = 1.0 / float(self.frame_number)
        self.frame_number += 1
        for g, camera in zip(self.groups, self._launch_cameras()):
            g.accum = g._step(
                self.scene, g.accum, camera, np.uint32(self.seed),
                np.float32(part),
            )
        return self.groups[0].accum

    # step_frames chunk sizes: _step_n jit-specializes on the batch size
    # (seeds shape (n,) and, for the kernel, a grid=(n, blocks) program),
    # and a fresh compile takes seconds, so an interactive "frames N"
    # must NEVER compile a new N. Any request is served as a sequence of
    # these fixed chunks (largest first), bounding the engine to at most
    # len(CHUNKS) compiled step_n variants. Bit-identical
    # to n step_frame calls: seed/part sequences are computed on the host
    # per chunk and the per-chunk blends compose exactly like
    # consecutive single steps.
    STEP_CHUNKS = (128, 32, 8, 1)

    def step_frames(self, n: int) -> jnp.ndarray:
        """Render ``n`` accumulation frames in a few dispatches per group
        (idle-viewer batching), quantized to STEP_CHUNKS
        so distinct ``n`` never trigger fresh compiles."""
        while n > 0:
            chunk = next(c for c in self.STEP_CHUNKS if c <= n)
            self.step_launch(chunk)
            n -= chunk
        return self.groups[0].accum

    def step_launch(self, n: int) -> jnp.ndarray:
        """One ``n``-frame dispatch per group. Every distinct ``n``
        compiles its own step_n, so live sessions go through
        `step_frames`, which only uses STEP_CHUNKS sizes."""
        if n <= 0:
            return self.groups[0].accum
        seeds, parts = [], []
        for _ in range(n):
            self.seed ^= generate_seed(
                self._np_rng, wall_clock=not self._deterministic
            )
            self._rng_draws += 1
            seeds.append(self.seed)
            parts.append(1.0 / float(self.frame_number))
            self.frame_number += 1
        seeds = np.asarray(seeds, np.uint32)
        parts = np.asarray(parts, np.float32)
        for g, camera in zip(self.groups, self._launch_cameras()):
            g.accum = g._step_n(self.scene, g.accum, camera, seeds, parts)
        return self.groups[0].accum

    def precompile(self) -> float:
        """Warm every jitted step variant this engine can ever dispatch
        (per group: the single-frame step + one step_n per STEP_CHUNKS
        member) BEFORE the first interactive frame, so a live session
        never stalls on a compile mid-interaction (the reference is
        responsive from frame 1,
        main.cpp:79-106). Executes each variant once on throwaway
        buffers — engine state (seed sequence, frame counter,
        accumulation) is untouched — because the jit call cache is
        populated by calls, and execute-and-discard also covers any
        backend warm-up the first dispatch pays. Returns seconds spent
        (the measured time-to-first-frame the app logs)."""
        t0 = time.monotonic()
        for g in self.groups:
            camera = g.camera(self)
            # jnp.copy: the step donates its accum argument; the copy is
            # consumed, g.accum stays valid.
            out = g._step(
                self.scene, jnp.copy(g.accum), camera,
                np.uint32(1), np.float32(1.0),
            )
            for c in self.STEP_CHUNKS:
                seeds = np.arange(1, c + 1, dtype=np.uint32)
                parts = np.full((c,), np.float32(1.0))
                out = g._step_n(
                    self.scene, jnp.copy(g.accum), camera, seeds, parts
                )
            jax.block_until_ready(out)
        return time.monotonic() - t0

    def run(self, n_frames: int) -> jnp.ndarray:
        for _ in range(n_frames):
            self.step_frame()
        return self.groups[0].accum

    def windows(self) -> List[Tuple[str, np.ndarray]]:
        """(view_name, HxWx3 image) per window across all groups — the
        presentation-layer contract (one PNG per window)."""
        out = []
        for g in self.groups:
            acc = np.asarray(g.accum)
            if acc.ndim == 3:
                acc = acc[None]
            out.extend(zip(g.views, acc))
        return out

    def rays_per_frame(self) -> int:
        return sum(
            len(g.views) * g.cfg.width * g.cfg.height * g.cfg.samples
            for g in self.groups
        )

    # --- checkpoint / resume (SURVEY §5: the reference's accumulation
    # dies with the GL texture on exit; ours persists) ------------------

    def state_dict(self) -> dict:
        """Full resumable engine state: per-group accumulation buffers,
        frame counter, seed, and camera pose."""
        a = self.angles
        f = self.focus
        return {
            "accums": [np.asarray(g.accum) for g in self.groups],
            "frame_number": np.int32(self.frame_number),
            "seed": np.uint32(self.seed),
            "rng_draws": np.int64(self._rng_draws),
            "angles": np.asarray(
                [float(a.fi), float(a.te), float(a.psi)], np.float32
            ),
            "focus": np.asarray(
                [float(np.asarray(c)) for c in f], np.float32
            ),
        }

    def load_state_dict(self, state: dict) -> None:
        accums = state["accums"]
        if len(accums) != len(self.groups):
            raise ValueError(
                f"checkpoint has {len(accums)} view groups, engine has "
                f"{len(self.groups)}"
            )
        for g, acc in zip(self.groups, accums):
            acc = np.asarray(acc)
            if acc.shape != g.accum.shape:
                raise ValueError(
                    f"checkpoint accum shape {acc.shape} != {g.accum.shape}"
                )
            g.accum = jnp.asarray(acc)
        self.frame_number = int(state["frame_number"])
        self.seed = int(state["seed"])
        # Deterministic seed sequences resume exactly: replay the
        # per-frame RNG draws into a fresh generator.
        self._rng_draws = int(state.get("rng_draws", 0))
        self._np_rng = np.random.default_rng(0 if self._deterministic else None)
        for _ in range(self._rng_draws if self._deterministic else 0):
            self._np_rng.integers(0, 2**32)
        ang = np.asarray(state["angles"], np.float32)
        self.angles = cam.CameraAngles(
            jnp.float32(ang[0]), jnp.float32(ang[1]), jnp.float32(ang[2])
        )
        fc = np.asarray(state["focus"], np.float32)
        self.focus = Vec4.of(*fc)

    def save_checkpoint(self, path) -> None:
        from fourd_ray_tracing_tpu.utils import checkpoint

        checkpoint.save(path, self.state_dict())

    def load_checkpoint(self, path) -> None:
        from fourd_ray_tracing_tpu.utils import checkpoint

        self.load_state_dict(checkpoint.restore(path, self.state_dict()))
