"""chip_smoke.py's training phase on the CPU, one part per test, at a
tiny size (its own file, so a test worker runs it beside the other
phases)."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

from test_chip_smoke import TINY  # noqa: E402


@pytest.mark.parametrize("part", chip_smoke.TRAIN_PARTS)
def test_phase_train(part):
    out = chip_smoke.phase_train(**TINY, steps=2, small=(16, 8, 2, 2),
                                 parts=(part,))[part]
    if part == "vs_cpu":
        assert out["grad_rel_l2"] < 1e-2
    else:
        assert out["rays_per_s"] > 0 and out["temp_bytes"] > 0
