"""Multi-host (2-process jax.distributed) correctness, via subprocess.

Spawns tools/multihost_run.py: 2 OS processes x 4 virtual CPU devices,
one global 4x2 (rays x samples) mesh, psum crossing the process
boundary. The worker reports the sharded mean light and scene-gradient
norm; this test recomputes both single-process and compares — multi-host
must change nothing but the wall clock (SURVEY §2.4, BASELINE.md:18).
"""
import json
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def multihost_result():
    port = _free_port()
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "multihost_run.py"),
         "--nprocs", "2", "--port", str(port), "--frames", "1"],
        capture_output=True, text=True, timeout=900, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("{")][-1]
    return json.loads(line)


def _expected():
    from fourd_ray_tracing_tpu import camera as cam
    from fourd_ray_tracing_tpu.models import library
    from fourd_ray_tracing_tpu.models.renderer import RenderConfig, render_light
    from fourd_ray_tracing_tpu.ops.vec4 import Vec4
    from tools.multihost_run import BOUNCES, HEIGHT, SAMPLES, WIDTH

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, samples=SAMPLES,
                       reflections_amount=BOUNCES, rng_mode="per_sample")
    scene = library.sphere_plane_light()
    camera = cam.camera_from_state(
        Vec4.of(0.0, -2.0, 0.0, 0.0),
        cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)),
        1.5, 2.0,
    )
    mean = jnp.mean(render_light(scene, camera, cfg, jnp.uint32(7)))
    g = jax.grad(
        lambda s: jnp.mean(render_light(s, camera, cfg, jnp.uint32(7)))
    )(scene)
    return float(mean), float(optax.global_norm(g))


@pytest.mark.slow
def test_two_process_distributed_matches_single_process(multihost_result):
    assert multihost_result["global_devices"] == 8
    want_mean, want_gn = _expected()
    # Sharded sums re-associate adds; tolerance is float32 re-association.
    np.testing.assert_allclose(multihost_result["mean_light"], want_mean, rtol=1e-5)
    np.testing.assert_allclose(multihost_result["grad_norm"], want_gn, rtol=1e-4)
    assert multihost_result["rays_per_s"] > 0


@pytest.mark.slow
def test_two_process_kernel_path(multihost_result):
    """The forward kernel across the process boundary: its block axis
    sharded over the global mesh (Pallas interpreter on CPU workers)
    renders the same image as the jnp pipeline, so the means agree to
    re-association."""
    want_mean, _ = _expected()
    np.testing.assert_allclose(
        multihost_result["kernel_mean_light"], want_mean, rtol=1e-5
    )
    assert multihost_result["kernel_rays_per_s"] > 0
