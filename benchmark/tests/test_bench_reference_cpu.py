"""The plain references against the port at tiny widths on the CPU, and the
comparison failing a bfloat16 run: the synthesis reference
(``reference/matcha.py``) against ``SynthesisPipeline``, GPT-J's and
Whisper's (``reference/gptj.py``, ``reference/whisper.py``) against the
transformers models the port decodes."""

from __future__ import annotations

import ast
from pathlib import Path

import torch

from benchmark.checks import tts as tts_check
from benchmark.configs import matcha_emoji_v1
from benchmark.reference import gptj as ref_gptj
from benchmark.reference import matcha as ref
from benchmark.reference import whisper as ref_whisper
from benchmark.tests import tiny
from benchmark.weights import draw

TEXTS = ["Hello there, my robot friend! The sea is calm today. 😎", "A short one."]


def pipeline(cfg, seed, **kw):
    """The system as the cells build it; with `kw`, the same modules in
    another pipeline (such as ``compute_dtype=torch.bfloat16``)."""
    p = matcha_emoji_v1.build(cfg, seed, "cpu").pipe
    if not kw:
        return p
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline

    return SynthesisPipeline(p.model_cfg, p.model, p.vocoder_cfg, p.vocoder, device="cpu", graphs=True,
                             text_buckets=p.text_buckets, mel_buckets=p.mel_buckets, cleaners=p.cleaners, **kw)


def served(pipe, cfg):
    s = cfg["synthesis"]
    res = pipe.synthesise(TEXTS, spks=[79, 12], seed=[11, 12], n_timesteps=s["n_timesteps"],
                          temperature=s["temperature"], denoiser_strength=s["denoiser_strength"], pcm16=True)
    rows = [dict(text=t, spk=spk, seed=sd, length_scale=1.0, samples=len(r.wav), wav=r.wav)
            for t, spk, sd, r in zip(TEXTS, (79, 12), (11, 12), res)]
    return rows


def judge(cfg, seed, rows):
    weights = matcha_emoji_v1.reference_weights(cfg, seed, "cpu")
    return tts_check.check(cfg, weights, rows, list(range(len(rows))), len(rows), "cpu")


def test_text_front_end_matches_the_pipelines():
    cfg = tiny.matcha()
    pipe = pipeline(cfg, 3)
    from benchmark.traffic import generate

    texts = TEXTS + [r["text"] for r in generate.make("poisson_replies", 5, 2)["requests"][:20]]
    for t in texts:
        x, xl, _, _ = pipe.encode_texts([t])
        assert list(x[0][: xl[0]]) == ref.text_ids(t)


def test_synthesis_reference_matches_the_pipeline():
    cfg = tiny.matcha()
    out = judge(cfg, 3, served(pipeline(cfg, 3), cfg))
    assert out["judged"] == 2 and out["wrong_length"] == 0
    assert out["wav_share_2lsb"] == 0.0 and round(out["wav_err"] * 32767) <= 1  # one int16 step at most


def test_bf16_synthesis_fails_the_comparison():
    cfg = tiny.matcha()
    out = judge(cfg, 3, served(pipeline(cfg, 3, compute_dtype=torch.bfloat16), cfg))
    limits = {"wav_share_2lsb": 2.5e-5, "wrong_length": 0}
    assert any(out[k] > v for k, v in limits.items()), out


def test_duration_calibration_sets_the_speaking_rate():
    cfg = tiny.matcha()
    cfg["durations"]["chars_per_s"] = 14.0
    sd, _ = matcha_emoji_v1.reference_weights(cfg, 9, "cpu")
    text = "the robot walked along the quiet river and sang a little song to the fish"
    frames = ref.encode(sd, cfg["model"], ref.text_ids(text), 12, 1.0)[3]
    assert 0.5 < frames / (len(text) / 14.0 * 22050 / 256) < 2.0


def _tiny_llm():
    return dict(vocab_size=300, n_embd=64, n_layer=2, n_head=4, rotary_dim=8, n_positions=128,
                activation_function="gelu_new", tie_word_embeddings=False)


def test_gptj_reference_matches_transformers_and_bf16_fails():
    from emojivoice_tpu_torch.apps.torch_adapters import import_transformers

    tf = import_transformers()
    cfg = _tiny_llm()
    model = tf.GPTJForCausalLM(tf.GPTJConfig(**cfg)).eval()
    sd = dict(model.named_parameters())
    draw(ref_gptj.spec(cfg), 5, "cpu", out=sd)
    ids = torch.randint(0, 300, (40,), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = model(ids[None]).logits[0]
    want = ref_gptj.logits(sd, cfg, ids)
    assert float((got - want).abs().max()) < 1e-5
    low = ref_gptj.logits(sd, cfg, ids, dtype=torch.bfloat16)
    gap = want.max(-1).values - want.gather(-1, low.argmax(-1, keepdim=True))[:, 0]
    assert float(gap.max()) > 1e-3


def test_whisper_reference_matches_transformers():
    from emojivoice_tpu_torch.apps.torch_adapters import import_transformers

    tf = import_transformers()
    cfg = dict(vocab_size=51864, d_model=32, encoder_layers=2, decoder_layers=2, encoder_attention_heads=2,
               decoder_attention_heads=2, encoder_ffn_dim=64, decoder_ffn_dim=64, num_mel_bins=80,
               max_source_positions=1500, max_target_positions=448)
    model = tf.WhisperForConditionalGeneration(tf.WhisperConfig(**cfg)).eval()
    sd = dict(model.named_parameters())
    assert set(n for n, _, _ in ref_whisper.spec(cfg)) == set(sd)
    draw(ref_whisper.spec(cfg), 6, "cpu", out=sd)
    feats = torch.randn(80, 3000, generator=torch.Generator().manual_seed(1))
    toks = torch.tensor([50257, 100, 200, 300])
    with torch.no_grad():
        got = model(input_features=feats[None], decoder_input_ids=toks[None]).logits[0]
    assert float((got - ref_whisper.logits(sd, cfg, feats, toks)).abs().max()) < 1e-5


def test_reference_imports_nothing_of_the_program():
    for path in (Path(__file__).resolve().parents[1] / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for n in names:
                assert n.split(".")[0] not in {"emojivoice_tpu_torch", "emojivoice_tpu", "jax", "flax"}, (path, n)
