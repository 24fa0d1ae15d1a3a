"""Smoke tests for the user-facing tools."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def test_inverse_render_script_recovers_glow():
    from tools.inverse_render import main

    rc = main([
        "--param", "glow", "--steps", "60", "--width", "24", "--height", "16",
        "--samples", "2", "--bounces", "2", "--lr", "0.5", "--log-every", "30",
        "--tol", "5.0",  # tiny-workload floor: eager target vs jitted
        # training render differ on boundary pixels, biasing the optimum
        # (exact recovery within 2.0 is covered by test_grad.py)
    ])
    assert rc == 0


def test_gen_goldens_camera_matches_production():
    """The oracle camera the goldens were rendered with must equal the
    production camera's numbers exactly (same float32 ops)."""
    import numpy as np
    import jax.numpy as jnp

    from tools.gen_goldens import oracle_camera
    from fourd_ray_tracing_tpu import camera as cam
    from fourd_ray_tracing_tpu.ops.vec4 import Vec4

    oc = oracle_camera()
    pc = cam.camera_from_state(
        Vec4.of(0.0, -2.0, 0.0, 0.0),
        cam.CameraAngles(jnp.float32(0), jnp.float32(0), jnp.float32(0)),
        1.5, 2.0,
    )
    np.testing.assert_array_equal(oc.focus, np.asarray(pc.focus.stack()))
    np.testing.assert_array_equal(oc.vec_to_mtr, np.asarray(pc.vec_to_mtr.stack()))
    np.testing.assert_array_equal(oc.top, np.asarray(pc.top.stack()))
    np.testing.assert_array_equal(oc.right, np.asarray(pc.right.stack()))
    assert oc.mtr_width == float(pc.mtr_width)
    assert oc.mtr_height == float(pc.mtr_height)


@pytest.mark.slow
def test_inverse_render_packed_production_loop(tmp_path):
    """--packed: the packed-space loop (adam on one flat parameter
    vector, train-state checkpoints) recovers the glow within the tested
    tiny-workload tolerance and writes a resumable checkpoint."""
    from fourd_ray_tracing_tpu.utils import checkpoint
    from tools.inverse_render import main

    ck = tmp_path / "ck"
    rc = main([
        "--param", "glow", "--steps", "60", "--width", "24", "--height", "16",
        "--samples", "2", "--bounces", "2", "--lr", "0.5", "--log-every", "30",
        "--tol", "5.0", "--packed", "--ckpt", str(ck),
    ])
    assert rc == 0
    meta = (ck / "fourd_ckpt_meta.json")
    assert meta.exists()  # versioned train-state artifact written


def test_peak_table_knows_h100_and_refuses_unknown_devices():
    import bench

    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == {"fp32_flops": 67e12, "hbm_bytes": 3.35e12}
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks("Some Future Accelerator")


@pytest.fixture
def restore_cache_config():
    import jax

    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield jax.config
    for k, v in saved.items():
        jax.config.update(k, v)


def test_compile_cache_env_dir_is_left_to_jax(monkeypatch, tmp_path,
                                              restore_cache_config):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets nothing."""
    from fourd_ray_tracing_tpu.utils.compile_cache import setup_compile_cache

    config = restore_cache_config
    config.update("jax_compilation_cache_dir", "/untouched")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert setup_compile_cache() == str(tmp_path)
    assert config.jax_compilation_cache_dir == "/untouched"


def test_compile_cache_defaults_to_repo_dir(monkeypatch, restore_cache_config):
    """Without the variable, the cache goes to <repo>/.jax_cache."""
    from fourd_ray_tracing_tpu.utils.compile_cache import setup_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(Path(__file__).resolve().parent.parent / ".jax_cache")
    assert setup_compile_cache() == want
    assert restore_cache_config.jax_compilation_cache_dir == want
