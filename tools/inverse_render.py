"""End-to-end inverse rendering: recover scene parameters from targets.

BASELINE.md workload 5 as a user-facing script: render target images of
a scene, perturb chosen parameters, then optimize them back with the
jitted train step (optionally sharded over a device mesh, optionally
with soft-silhouette gradients for geometry). Logs one JSON metrics line
per step (host 0 only) and checkpoints optimizer + scene state.

Examples:
  # photometric: recover the lamp's glow
  python tools/inverse_render.py --param glow --steps 60

  # geometry through a silhouette (soft mode)
  python tools/inverse_render.py --param position --steps 150

  # sharded over all local devices
  python tools/inverse_render.py --param glow --mesh
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax

from fourd_ray_tracing_tpu.utils.compile_cache import setup_compile_cache

setup_compile_cache()

import jax.numpy as jnp
import numpy as np
import optax

from fourd_ray_tracing_tpu import camera as cam
from fourd_ray_tracing_tpu.diff import make_train_step
from fourd_ray_tracing_tpu.models.renderer import RenderConfig, render_image
from fourd_ray_tracing_tpu.models.scene import Scene, material, space, sphere
from fourd_ray_tracing_tpu.ops.vec4 import Vec4
from fourd_ray_tracing_tpu.utils import checkpoint
from fourd_ray_tracing_tpu.utils.logging import log0, log_metrics


def make_scene(cx, glow):
    """Floor + mirror-ish sphere + optimizable lamp sphere (the
    sphere-plane-light family, scenes/Шар, плоскость и светилник.frag)."""
    from fourd_ray_tracing_tpu.models import library

    base = library.sphere_plane_light()
    lamp = sphere((cx, 1, 0, 0), 0.5, material(glow, 0.0, (1, 1, 1)))
    return base._replace(spheres=(base.spheres[0], lamp))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--param", choices=("glow", "position"), default="glow")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=40)
    ap.add_argument("--samples", type=int, default=2)
    ap.add_argument("--bounces", type=int, default=2)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--mesh", action="store_true",
                    help="shard rays/samples over all local devices")
    ap.add_argument("--packed", action="store_true",
                    help="hard loss only: the packed-space loop "
                    "(diff.make_packed_train_step — adam on one flat "
                    "parameter vector), checkpointed via "
                    "save_train_state")
    ap.add_argument("--ckpt", default=None, help="checkpoint dir (save each 20 steps)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--tol", type=float, default=None,
                    help="success threshold on |recovered - true| "
                    "(default: 2.0 glow / 0.1 position). Tiny workloads "
                    "have an irreducible floor: the eagerly-rendered "
                    "target and the jitted training render differ on "
                    "visibility-boundary pixels, which biases the "
                    "minimum slightly.")
    args = ap.parse_args(argv)

    cfg = RenderConfig(
        width=args.width, height=args.height, samples=args.samples,
        reflections_amount=args.bounces, rng_mode="per_sample",
    )
    camera = cam.camera_from_state(
        Vec4.of(0.0, -2.0, 0.0, 0.0),
        cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)),
        1.5, 2.0,
    )
    mesh = None
    if args.mesh:
        from fourd_ray_tracing_tpu.parallel.mesh import make_mesh

        n = len(jax.devices())
        mesh = make_mesh(rays=n, samples=1)
        if args.height % n:
            raise SystemExit(f"--height must divide by {n} devices")

    if args.param == "glow":
        true_val, init_val = 20.0, 8.0
        target = render_image(make_scene(1.0, true_val), camera, cfg, args.seed)
        scene0 = make_scene(1.0, init_val)
        lr, soft = args.lr or 0.5, None

        def param_filter(g):
            z = jax.tree.map(jnp.zeros_like, g)
            mat = z.spheres[1].material._replace(glow=g.spheres[1].material.glow)
            return z._replace(spheres=(z.spheres[0], z.spheres[1]._replace(material=mat)))

        read = lambda s: float(s.spheres[1].material.glow)
    else:  # position: silhouette-driven, needs soft gradients
        true_val, init_val = 1.4, 1.0
        target = render_image(make_scene(true_val, 20.0), camera, cfg, args.seed)
        scene0 = make_scene(init_val, 20.0)
        lr, soft = args.lr or 0.03, 1

        def param_filter(g):
            z = jax.tree.map(jnp.zeros_like, g)
            c = z.spheres[1].center._replace(x=g.spheres[1].center.x)
            return z._replace(spheres=(z.spheres[0], z.spheres[1]._replace(center=c)))

        read = lambda s: float(s.spheres[1].center.x)

    opt = optax.adam(lr)

    if args.packed:
        if soft is not None:
            raise SystemExit("--packed trains the hard loss (--param glow)")
        from fourd_ray_tracing_tpu.diff import make_packed_train_step

        pstep, pinit, unpack = make_packed_train_step(
            cfg, opt, camera, scene0, param_filter=param_filter, mesh=mesh
        )
        vec, opt_state = pinit(scene0)
        for k in range(args.steps):
            vec, opt_state, loss = pstep(vec, opt_state,
                                         np.uint32(args.seed), target)
            if k % args.log_every == 0 or k == args.steps - 1:
                log_metrics(k, {"loss": float(loss),
                                "value": read(unpack(vec))})
            if args.ckpt and k % 20 == 19:
                checkpoint.save_train_state(Path(args.ckpt), vec, opt_state,
                                            step=k + 1)
        scene = unpack(vec)
        err = abs(read(scene) - true_val)
        log0(f"recovered {args.param}={read(scene):.4f} "
             f"(true {true_val}, err {err:.4f})")
        tol = args.tol if args.tol is not None else 2.0
        return 0 if err < tol else 1

    step = make_train_step(cfg, opt, camera, mesh=mesh,
                           param_filter=param_filter,
                           soft_sphere_index=soft, edge_width=0.08)
    scene, opt_state = scene0, opt.init(scene0)
    for k in range(args.steps):
        scene, opt_state, loss, metrics = step(scene, opt_state,
                                               np.uint32(args.seed), target)
        if k % args.log_every == 0 or k == args.steps - 1:
            log_metrics(k, {**metrics, "value": read(scene)})
        if args.ckpt and k % 20 == 19:
            checkpoint.save(Path(args.ckpt), {"scene": scene, "opt": opt_state})
    err = abs(read(scene) - true_val)
    log0(f"recovered {args.param}={read(scene):.4f} (true {true_val}, err {err:.4f})")
    tol = args.tol if args.tol is not None else (2.0 if args.param == "glow" else 0.1)
    return 0 if err < tol else 1


if __name__ == "__main__":
    sys.exit(main())
