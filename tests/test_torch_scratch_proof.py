"""The port's from-scratch proof (``training/scratch_proof.py``) on the CPU at
the tiny preset and the size of ``tests/test_scratch_proof.py``'s run of the
JAX tool (24 steps, a probe every 8): the harness runs end to end, the probes
land in ``metrics.jsonl``, the free synthesis is reported, and
``summary.json`` carries the JAX tool's keys (read from its source, so that
the two cannot drift apart).

The emergence asserts are off here.  24 steps of a tiny model do not settle
the duration predictor in the port's random streams (its log-duration MSE
reads 0.83 → 1.23 while diagonality goes 0.82 → 0.91), and choosing another
seed or size until they pass would prove nothing.  Emergence is held where it
means something: on the card, at emoji_multi width (``chip_smoke.py``'s
``[scratch]`` phase, and the 4,000-step run of PERF.md, whose asserts all
hold)."""

import ast
import json
from pathlib import Path

import pytest
import torch

from emojivoice_tpu_torch.training.scratch_proof import main, run_scratch_proof

torch.set_num_threads(2)

JAX_TOOL = Path(__file__).resolve().parents[1] / "emojivoice_tpu" / "training" / "scratch_proof.py"


def _jax_summary_keys():
    """The keys of the ``summary`` dict literal in the JAX tool's
    ``run_scratch_proof``, and those of its ``free_synth`` entry."""
    tree = ast.parse(JAX_TOOL.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "summary" for t in node.targets) \
                and isinstance(node.value, ast.Dict):
            keys = [k.value for k in node.value.keys]
            free = node.value.values[keys.index("free_synth")]
            return set(keys), {k.value for k in free.keys}
    raise AssertionError("no summary literal in the JAX tool")


@pytest.fixture(scope="module")
def proof(tmp_path_factory):
    out = tmp_path_factory.mktemp("scratch")
    summary = run_scratch_proof("tiny", str(out), steps=24, batch_size=4, probe_every=8, utts=6, n_speakers=3,
                                lr=2e-3, log_every=2, assert_emergence=False, assert_free_synth=False, device="cpu")
    return out, summary


def test_harness_on_the_cpu_and_the_jax_tools_keys(proof):
    out, summary = proof
    keys, free_keys = _jax_summary_keys()
    assert set(summary) == keys
    assert set(summary["free_synth"]) == free_keys
    assert summary["backend"] == "cpu" and summary["devices"] == 1 and summary["from_scratch"] is True
    assert summary["probe_steps"] == [0, 8, 16, 24]
    assert len(summary["diagonality"]) == 4 and len(summary["mas_drift_l1"]) == 3
    assert json.loads((out / "summary.json").read_text()) == summary
    probes = [r for r in map(json.loads, (out / "run" / "metrics.jsonl").read_text().splitlines())
              if r["tag"] == "probe"]
    assert all("mas_dur_row0" in p for p in probes)
    fs = summary["free_synth"]
    assert fs["frames_gt"] > 0 and fs["frames_pred"] > 0 and fs["mel_l1_overlap"] > 0
    assert summary["corpus"]["n_utts"] == 6
    census = summary["shape_census"]
    assert census["distinct_shapes"] >= 1 and all(s["first_step"] <= 24 for s in census["shapes"])
    assert set(summary["step_rate"]) == {"first_half_steps_per_s", "second_half_steps_per_s"}


def test_main_keeps_the_evidence_of_a_run_that_misses_its_budget(tmp_path):
    """``--artifact_dir`` receives metrics.jsonl and summary.json even when
    an assert fails: a 3-step run cannot meet the free-synthesis budget."""
    art = tmp_path / "art"
    with pytest.raises(AssertionError):
        main(["--preset", "tiny", "--device", "cpu", "--out_dir", str(tmp_path / "run"), "--steps", "3",
              "--batch_size", "2", "--probe_every", "1", "--utts", "2", "--n_speakers", "2", "--log_every", "1",
              "--length_budget", "0.0", "--artifact_dir", str(art)])
    assert (art / "metrics.jsonl").exists()
    assert json.loads((art / "summary.json").read_text())["steps"] == 3
