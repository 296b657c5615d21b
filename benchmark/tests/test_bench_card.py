"""On the card: each cell's control fails its check.  The control is the
reference in TF32, the nearest precision below the configurations' float32
with TF32 off, put in the program's place on the run's own rows and
positions and judged by the same limits (``run.py --control``); a sound run
is correct and the control is not.  Skips without a card:

    python -m pytest -m cuda benchmark/tests/test_bench_card.py -q
"""

from __future__ import annotations

import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the cells run on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tts_serve_poisson", "agent_turn_gptj"])
def test_control_fails_and_sound_run_passes(cuda, cell):
    from benchmark import run as R

    res = R.run(cell, 2**31 + 1234, 10.0, False, torch.device("cuda", 0), control=True)
    assert res["correct"], res["checks"]
    assert not res["control"]["correct"], res["control"]
