"""chip_smoke.py on the CPU: every phase function at a tiny size (the
kernel in the Pallas interpreter), and the script's refusal to run, or
to print a result, without a GPU."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

from test_app import TINY_CONFIG  # noqa: E402

# Two bounces: at one, no path in the room reaches its light.
TINY = dict(width=32, height=16, samples=2, bounces=2)


def test_exits_nonzero_without_gpu():
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_phase_app(tmp_path):
    p = tmp_path / "properties.txt"
    p.write_text(TINY_CONFIG.replace("show_additional_windows = false",
                                     "show_additional_windows = true"))
    out = chip_smoke.phase_app(config=p, frames=2, out_dir=tmp_path / "out")
    assert set(out["pngs"]) == {"yxz", "ywz", "yxw"}


def test_phase_forward_kernel_vs_xla():
    out = chip_smoke.phase_forward(**TINY, frames=2, impl="pallas",
                                   interpret=True, goldens=False)
    assert out["engine_impl"] == "pallas"
    for case in ("room", "tiger_3view"):
        assert set(out[case]) == {"primary", "multibounce"}


def test_compare_goldens_kernel_and_xla():
    out = chip_smoke.compare_goldens(interpret=True,
                                     scenes=("sphere_plane_light",))
    assert set(out) == {"sphere_plane_light/pallas", "sphere_plane_light/xla"}


def test_phase_timing(tmp_path):
    p = tmp_path / "properties.txt"
    p.write_text(TINY_CONFIG)
    out = chip_smoke.phase_timing(**TINY, interactive=p, launches=1,
                                  interpret=True)
    assert set(out) == {"room_1280x720x8x4", "tiger_3view_1280x720x8x4",
                        "interactive_properties"}
    for v in out.values():
        assert v["xla"]["rays_per_s"] > 0 and v["pallas"]["rays_per_s"] > 0


@pytest.mark.slow
def test_phase_four_cards():
    out = chip_smoke.phase_four_cards(**TINY, interpret=True)
    assert set(out) == {"render_4x1", "render_2x2", "train_2x2"}
