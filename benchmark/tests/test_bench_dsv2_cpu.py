"""agent_turn_dsv2lite's whole run on the CPU at tiny widths (the harness's
look for a chip skipped), through ``run.run(..., configs={tiny})``: a sound
run comes out correct and reports ``llm_logit_err``; a token moved where it
is produced fails ``token_gap``, scores moved by a part in a hundred
where they are produced (what TF32 does to them) fail ``llm_logit_err``
though they choose the same tokens, and so does a prefill whose routed
experts alone (K3's grouped path) are off by three tenths.  Beside it, the yardstick's count of
K3's bytes and the load-imbalance reader."""

from __future__ import annotations

import copy
from pathlib import Path

import pytest
import torch

from benchmark import run as R
from benchmark import work_moe
from benchmark.harness import Record, Spans, load_json, load_module
from benchmark.tests import tiny

SEED = 2**31 + 91
ROOT = Path(__file__).resolve().parents[2]
CELL = "agent_turn_dsv2lite"

# DeepSeek-V2's mechanisms at a size a test holds: the first layer dense, 8 experts top-2 and 2 shared, yarn rotary
TINY_LLM = dict(hidden_size=64, intermediate_size=96, num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=4,
                kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
                num_experts_per_tok=2, n_shared_experts=2, moe_intermediate_size=24)


def dsv2_config() -> dict:
    """agent_whisper_dsv2lite at tiny widths: the chat LM's top-level keys
    shrunk (its vocabulary and special ids kept, which the stub tokenizer
    needs), Whisper and the synthesis as ``tiny.agent()``'s."""
    cfg = copy.deepcopy(load_json(ROOT / "benchmark" / "configs" / "agent_whisper_dsv2lite.json"))
    small = tiny.agent()
    cfg.update(TINY_LLM, whisper=small["whisper"], tts=small["tts"], agent=small["agent"])
    return cfg


def run(seconds: float = 0.5) -> dict:
    return R.run(CELL, SEED, seconds, False, "cpu", configs={"agent_whisper_dsv2lite": dsv2_config()})


@pytest.fixture(autouse=True)
def threads():
    torch.set_num_threads(4)


def test_sound_run_is_correct_and_reads_the_last_logits():
    res = run()
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["checks"]) == {"token_gap", "speech_err", "llm_logit_err", "llm_router_ties"}
    assert res["checks"]["llm_logit_err"]["value"] < 1e-5
    assert set(res["metrics"]) >= {"setup_s", "first_audio_ms"}


def test_altered_token_is_not_correct(monkeypatch):
    from emojivoice_tpu_torch.apps import torch_adapters as ta

    real = ta.TorchChatLM._generate

    def generate_(self, ids, mask, generator=None, logits_out=None):
        seq = real(self, ids, mask, generator, logits_out)
        seq[0, ids.shape[1]] = (seq[0, ids.shape[1]] + 1) % 100000
        return seq
    monkeypatch.setattr(ta.TorchChatLM, "_generate", generate_)
    res = run()
    assert not res["correct"]
    assert res["checks"]["token_gap"]["value"] > res["checks"]["token_gap"]["limit"]


def test_scores_off_by_a_part_in_a_hundred_are_not_correct(monkeypatch):
    """The served scores scaled by 1 + 1e-2 after every turn (the size of the
    TF32 reference's error on the card, PERF.md): the same tokens, so only
    ``llm_logit_err`` can see it."""
    from emojivoice_tpu_torch.apps import torch_adapters as ta

    real = ta.TorchChatLM.last_logits
    monkeypatch.setattr(ta.TorchChatLM, "last_logits", lambda self: real(self) * (1 + 1e-2))
    res = run()
    checks = res["checks"]
    assert not res["correct"]
    assert checks["llm_logit_err"]["value"] > checks["llm_logit_err"]["limit"]
    assert checks["token_gap"]["value"] <= checks["token_gap"]["limit"]


def test_prefill_experts_off_by_three_tenths_are_not_correct(monkeypatch):
    """The routed experts' output scaled by 1.3 in the calls that take K3's
    grouped path (a prefill's, more than ``GEMV_PAIRS`` pairs) and in no
    decode step: only the prefill is wrong, and the first token's scores
    show it (here 5e-3 against 8e-4 at the last token, which reads it only
    through the cache).  At these tiny widths the routed experts add a small
    share of the residual stream, so the fault is made large; at
    DeepSeek-V2-Lite's on the card a scale of 1 + 1e-2 alone reads 1.7e-2
    (PERF.md §2)."""
    from emojivoice_tpu_torch.ops import moe

    real = moe.experts

    def experts_(x, ids, *a, **kw):
        out = real(x, ids, *a, **kw)
        return out * 1.3 if ids.numel() > moe.GEMV_PAIRS else out
    monkeypatch.setattr(moe, "experts", experts_)
    res = run()
    checks = res["checks"]
    assert not res["correct"]
    assert checks["llm_logit_err"]["value"] > checks["llm_logit_err"]["limit"]


def test_k3_bytes_are_the_experts_parameters():
    """A call that hits every expert with no rows reads each expert's
    weights once: the tiny model's routed-expert parameters of one layer,
    four bytes each."""
    from emojivoice_tpu_torch.apps.torch_adapters import import_transformers
    from benchmark.configs.agent_whisper_dsv2lite import llm_config

    cfg = llm_config(dsv2_config())
    tf = import_transformers()
    with torch.device("meta"):
        model = tf.DeepseekV2ForCausalLM(tf.DeepseekV2Config(**cfg))
    experts = sum(p.numel() for n, p in model.named_parameters() if ".mlp.experts." in n)
    layers = work_moe.moe_layers(cfg)
    assert layers == 3
    assert work_moe.call(cfg, 0, 0, cfg["n_routed_experts"]).bytes == 4 * experts / layers
    # a decode step of one row: k experts' weights a layer, the row in and out, and k ids and weights
    h, i, e, k = work_moe.widths(cfg)
    step = work_moe.decode_step(cfg)
    assert step.bytes == layers * (4 * (k * 3 * h * i + 2 * h) + 8 * k) and step.flops == layers * 6 * h * i * k


def test_load_imbalance_reads_the_window_counters():
    reader = load_module(ROOT / "benchmark" / "metrics" / "moe.load_imbalance.dsv2.py", "metric_moe_load")
    rec = Record(cell=CELL, window_s=1.0, setup_s=0.0, items=[], spans=Spans(), counters={},
                 extra=dict(config=dsv2_config()))
    assert reader.read(rec) is None  # a program without MoE counters: nothing to read
    rec.counters["moe"] = dict(before=dict(pairs=10, max_load=3, hits=5, steps=0),
                               after=dict(pairs=10 + 48, max_load=3 + 12, hits=9, steps=7))
    assert reader.read(rec) == pytest.approx(12 / (48 / 8))
