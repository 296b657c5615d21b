"""Each cell's whole run on the CPU at tiny widths (the harness's look for a
chip skipped): sound runs come out correct, and runs with a fault planted
in the timed path come out not correct — an answer altered where it is
produced (every synthesis call's audio reversed) and a token altered where
it is produced (the first token of every Whisper and chat reply moved by
one).  ``tts_offline_b32`` has its files but no entries in
``BENCHMARK.json`` yet: it runs here from a copy that adds them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark import run as R
from benchmark.tests import tiny
from benchmark.traffic import generate

SEED = 2**31 + 77
ROOT = Path(__file__).resolve().parents[2]
OFFLINE = dict(name="tts_offline_b32", config="matcha_emoji_v1", traffic="story_batches", chips=1,
               why="closed-loop batches of 32 story segments of 120-200 chars, no engine: HiFi-GAN with K1")


@pytest.fixture(autouse=True)
def short_traffic(monkeypatch):
    real = generate.load

    def load(name, directory=generate.TRAFFIC_DIR):
        mix = real(name, directory)
        if mix["kind"] == "story":
            mix["batches"] = 4
        return mix
    monkeypatch.setattr(generate, "load", load)
    torch.set_num_threads(4)


@pytest.fixture(scope="module")
def offline_root(tmp_path_factory):
    """A checkout whose BENCHMARK.json adds the offline cell and its metric."""
    root = tmp_path_factory.mktemp("offline")
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append(OFFLINE)
    bench["end_to_end"].append(dict(name="audio_s_per_s", unit="s/s", better="higher", bound=0.25,
                                    source="host_clock", workloads=[OFFLINE["name"]]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(cell: str, root: Path = ROOT, seconds: float = 0.5) -> dict:
    return R.run(cell, SEED, seconds, False, "cpu", root=root, configs=tiny.configs())


def cell_root(cell: str, request) -> Path:
    return request.getfixturevalue("offline_root") if cell == OFFLINE["name"] else ROOT


@pytest.mark.parametrize("cell", ["tts_serve_poisson", "tts_offline_b32", "agent_turn_gptj"])
def test_sound_run_is_correct(cell, request):
    res = run(cell, cell_root(cell, request))
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("cell", ["tts_serve_poisson", "tts_offline_b32"])
def test_altered_answer_is_not_correct(cell, monkeypatch, request):
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline

    real = SynthesisPipeline.finalize

    def finalize(self, p):
        out = real(self, p)
        for r in out:
            r.wav = r.wav[::-1].copy()
        return out
    monkeypatch.setattr(SynthesisPipeline, "finalize", finalize)
    res = run(cell, cell_root(cell, request))
    assert not res["correct"], res["checks"]


def test_altered_token_is_not_correct(monkeypatch):
    from emojivoice_tpu_torch.apps import torch_adapters as ta

    real = ta.TorchChatLM._generate

    def generate_(self, ids, mask, generator=None, logits_out=None):
        seq = real(self, ids, mask, generator, logits_out)
        seq[0, ids.shape[1]] = (seq[0, ids.shape[1]] + 1) % 50256
        return seq
    monkeypatch.setattr(ta.TorchChatLM, "_generate", generate_)
    res = run("agent_turn_gptj")
    assert not res["correct"], res["checks"]
    assert res["checks"]["token_gap"]["value"] > res["checks"]["token_gap"]["limit"]
