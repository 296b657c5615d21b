"""The port's measurement tools (``emojivoice_tpu_torch/bench/``) on the CPU.

* Each tool's ``main`` with ``--cpu`` at a tiny size (the tiny preset, 4
  speakers, with a narrow HiFi-GAN: ×16, 32 channels) returns 0 and prints one
  JSON line holding its JAX twin's keys (under the names the module's
  docstring maps), the card fields, and ``"not measured"`` wherever a time
  would stand; without ``--cpu``, on a machine with no card, each exits
  non-zero.
* ``synthesis.text_for_bucket`` picks the same text and predicted mel length
  as ``bench.py::_text_for_bucket`` on the same tiny weights (a flax init
  carried over through ``io/from_jax.py``, JAX on the CPU).
* The FLOP count from shapes (``bench/mfu.py``) against XLA's
  ``cost_analysis()`` of the JAX programs: HiFi-GAN at width 64, rates
  (4, 2), 64 frames within 0.5 % (0.08 % measured: the count leaves out
  elementwise work, which the 64-channel generator makes small).  The
  encoder and the decoder count products only, and at the tiny config's 16
  channels elementwise work is a sixth of XLA's count: measured ours / XLA =
  0.838 (encoder), 0.855 (decoder, 2 steps), 0.864 (10 steps); at
  emoji_multi's full width 0.9962 and 0.9909 (text bucket 256, mel bucket
  512, 2 steps; one CPU run).  So the bound here is [0.80, 1.0].
* The open loop (``serving.measure_open_loop``) over a stub engine with a
  fixed service time: the achieved rate is the requests over the submit
  window, the drain is apart (F3), and a stall shows in the latency of the
  requests behind it, which runs from when each was due.
* The F4 check (``synthesis.headline_vs_row``) flags a headline and a
  same-shape row whose medians are further apart than their spread, and not
  two that agree.
"""

import contextlib
import dataclasses
import io
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emojivoice_tpu import config as jax_cfglib
from emojivoice_tpu.vocoder import HiFiGANGenerator as FlaxHiFiGAN
from emojivoice_tpu_torch import config
from emojivoice_tpu_torch.bench import mfu, serving, synthesis, util

torch.set_num_threads(2)

NM = util.NOT_MEASURED
TINY = ["--cpu", "--preset", "bench_tiny", "--spk", "1"]
# each tool: its tiny settings, its twin's keys (top level), and paths (dotted, [i] for a list) that hold a time
TOOLS = {
    "synthesis": (TINY + ["--repeats", "2", "--sweep_repeats", "1", "--buckets", "512", "--batches", "1", "--steps",
                          "2"],
                  {"metric", "value", "unit", "vs_baseline", "provenance"},
                  ["value", "vs_baseline", "provenance.wall_ms", "provenance.sweep[0].rtf_w_per_utt",
                   "provenance.sweep[1].utt_per_s", "headline_vs_m512_b1.headline_rtf"]),
    "breakdown": (TINY + ["--repeats", "2", "--profiled", "1", "--steps", "2"],
                  {"metric", "compute_ms", "e2e_ms", "overhead_ms", "wav_payload_kb", "rtf_compute_only", "rtf_e2e"},
                  ["compute_ms", "e2e_ms", "overhead_ms", "rtf_e2e", "busy"]),
    "serving": (TINY + ["--clients", "2", "--window_s", "0.5", "--rates", "4", "--steps", "2", "--max_batch", "2"],
                {"metric", "mode", "device_kind", "max_batch", "max_wait_ms", "vocoder_bf16", "steps", "points"},
                ["points[0].utterances_per_s", "points[0].window_s", "points[1].p95_ms", "points[1].achieved_rate_per_s",
                 "points[1].drain_s", "points[1].late_ms_max"]),
    "ttfa": (TINY + ["--reps", "1", "--steps", "2"],
             {"preset", "steps", "backend", "device_kind", "segment_chars", "reps", "lengths"},
             ["lengths.short_reply_1s.full.ttfa_ms", "lengths.story_turn_10s.pipelined.total_ms"]),
    "exported": (TINY + ["--repeats", "2", "--steps", "1"],
                 {"backend", "text_chars", "steps", "repeats", "export_wall_s", "exported", "live", "generated"},
                 ["export_wall_s", "exported.wall_s_mean", "exported.rtf", "live.wall_s_std"]),
    "vocoder": (TINY + ["--frames", "16", "--iters", "1"],
                {"backend", "mel_frames", "plain_b1_ms", "k1_b1_ms", "k1_bf16_b1_ms", "plain_b8_ms", "k1_b8_ms",
                 "bf16_wav_max_abs_err", "fused_steps2_ms", "fused_steps10_ms", "cfm_per_step_ms", "non_cfm_ms"},
                ["plain_b1_ms", "k1_b8_ms", "cfm_per_step_ms"]),
    "vocoder_stages": (TINY + ["--batch", "1", "--frames", "16", "--reps", "1"],
                       {"backend", "batch", "frames", "conv_pre_ms", "ups0_ms", "mrf0_plain_ms", "mrf0_k1_ms",
                        "ups1_ms", "mrf1_plain_ms", "mrf1_k1_ms", "conv_post_ms"},
                       ["conv_pre_ms", "mrf1_k1_ms", "mrf0_plain_tflops"]),
    "mas": (["--cpu", "--b", "2", "--tx", "16", "--ty", "48", "--also_ty", "64", "--reps", "1", "--iters", "1"],
            {"metric", "lines"}, ["lines[0].value", "lines[1].compile_s", "lines[2].value"]),
    "train": (TINY + ["--b", "2", "--tx", "16", "--ty", "48", "--out_size", "16", "--iters", "1", "--gan_batch", "1",
                      "--gan_segment", "32", "--gan_iters", "1"],
              {"metric", "lines"}, ["lines[0].value", "lines[0].forward_ms", "lines[1].steps_per_s", "lines[4].value"]),
    "mfu": (TINY + ["--steps", "2", "--repeats", "1", "--train_batch", "2", "--train_tx", "16", "--train_ty", "48",
                    "--out_size", "16", "--voc_frames", "16"],
            {"device_kind", "backend", "compute_dtype", "note", "programs", "stages", "precision_sweep"},
            ["programs[0].device_ms_per_call", "programs[0].pct_of_peak", "stages.fused_ms",
             "precision_sweep[2].achieved_tflops"]),
    "multilingual": (TINY + ["--steps", "2", "--out", ""], {"backend", "steps", "model", "languages", "generated"},
                     ["languages.en.wall_seconds", "languages.ja.rtf"]),
}
# the twin's keys inside the nested records
NESTED = {
    "synthesis": {"provenance": {"device_kind", "backend", "path", "compute_dtype", "pcm16", "denoiser", "n_timesteps",
                                 "mel_bucket", "batch", "audio_s_per_utt", "sweep"},
                  "provenance.sweep[0]": {"case", "mel_bucket", "batch", "pred_mel_len", "rtf_w_per_utt", "utt_per_s",
                                          "audio_s_per_utt", "wall_ms"},
                  "provenance.sweep[1]": {"case", "batch", "rtf_w_per_utt", "utt_per_s", "wall_ms"}},
    "serving": {"points[0]": {"mode", "clients", "window_s", "requests", "utterances_per_s", "audio_s_per_wall_s",
                              "batches", "mean_batch", "mean_wait_ms"},
                "points[1]": {"mode", "offered_rate_per_s", "window_s", "requests", "achieved_rate_per_s", "p50_ms",
                              "p95_ms", "p99_ms", "max_ms", "batches", "mean_batch", "mean_wait_ms"}},
    "ttfa": {"lengths.reply_2sent_4s.auto": {"ttfa_ms", "total_ms", "audio_s"}},
    "exported": {"exported": {"audio_s", "wall_s_mean", "wall_s_std", "rtf"}, "live": {"audio_s", "wall_s_mean",
                                                                                         "wall_s_std", "rtf"}},
    "mas": {"lines[0]": {"metric", "value", "unit", "shape", "compile_s"}, "lines[2]": {"metric", "value", "unit"}},
    "train": {"lines[0]": {"metric", "value", "unit", "loss0", "compile_s", "shape"},
              "lines[1]": {"metric", "value", "unit", "steps_per_s"}, "lines[4]": {"metric", "value", "unit"}},
    "mfu": {"programs[0]": {"program", "flops_per_call", "gflops_per_call", "device_ms_per_call", "achieved_tflops",
                            "bytes_per_call", "mbytes_per_call", "achieved_gbps", "arith_intensity_flop_per_byte",
                            "pct_of_peak", "roofline_bound", "ridge_intensity", "roofline_ceiling_tflops",
                            "pct_of_roofline_ceiling"},
            "stages": {"programs", "stage_sum_ms", "fused_ms", "fusion_gain_pct"}},
    "multilingual": {"languages.fr": {"chars", "segments", "audio_seconds", "wall_seconds", "rtf", "wav_abs_max"}},
}


def bench_tiny(**overrides):
    root = config.tiny(**overrides)
    return dataclasses.replace(root, vocoder=config.HiFiGANConfig(
        upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
        resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3))))


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(config.PRESETS, "bench_tiny", bench_tiny)


def at(obj, path: str):
    for part in path.replace("]", "").replace("[", ".").split("."):
        obj = obj[int(part)] if isinstance(obj, list) else obj[part]
    return obj


def run(name: str, argv: list) -> dict:
    import importlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = importlib.import_module(f"emojivoice_tpu_torch.bench.{name}").main(argv)
    lines = [line for line in buf.getvalue().splitlines() if line.startswith("{")]
    assert rc == 0 and len(lines) == 1, (rc, buf.getvalue()[-2000:])
    return json.loads(lines[0])


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_runs_on_the_cpu_with_its_twins_keys(name, tiny_preset, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # a tool that wrote a file would write it here
    argv, keys, times = TOOLS[name]
    report = run(name, argv)
    assert keys <= set(report), keys - set(report)
    for path, want in NESTED.get(name, {}).items():
        assert want <= set(at(report, path)), (path, want - set(at(report, path)))
    assert (report["device"], report["count"], report["power_limit_w"]) == ("cpu", 0, NM)
    for path in times:
        assert at(report, path) == NM, (path, at(report, path))
    assert not list(tmp_path.rglob("*")), list(tmp_path.rglob("*"))


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_tool_without_a_card_exits_non_zero(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the tool would measure on it")
    import importlib

    argv = [a for a in TOOLS[name][0] if a != "--cpu"]
    with pytest.raises(SystemExit) as e:
        importlib.import_module(f"emojivoice_tpu_torch.bench.{name}").main(argv)
    assert e.value.code not in (0, None)


@pytest.fixture(scope="module")
def bridged():
    """(JAX pipeline, port pipeline) on one flax init of the tiny config."""
    from emojivoice_tpu.inference.pipeline import SynthesisPipeline as JaxPipeline
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.io.from_jax import hifigan_state_dict_from_flax, matcha_state_dict_from_flax
    from tests.test_torch_serving import flax_tiny_params, port_root

    jax_root, params, voc_params = flax_tiny_params(0)
    root = port_root(jax_root)
    jp = JaxPipeline(jax_root.model, params, jax_root.vocoder, voc_params, cleaners=("basic_cleaners",))
    pp = SynthesisPipeline.from_state_dicts(root.model, matcha_state_dict_from_flax(params, root.model), root.vocoder,
                                            hifigan_state_dict_from_flax(voc_params, root.vocoder), device="cpu",
                                            cleaners=("basic_cleaners",))
    return jp, pp


@pytest.mark.parametrize("bucket,lo", [(64, 32), (128, 64)])
def test_text_for_bucket_matches_bench_py(bridged, bucket, lo):
    import bench

    jp, pp = bridged
    want = bench._text_for_bucket(jp, bucket, lo, 1, util.HEADLINE)
    got = synthesis.text_for_bucket(pp, bucket, lo, 1, util.HEADLINE)
    assert got == want and lo < got[1] <= bucket, (got, want)


def _xla_flops(lowered) -> float:
    cost = lowered.compile().cost_analysis()
    return float((cost[0] if isinstance(cost, (list, tuple)) else cost)["flops"])


def test_hifigan_count_matches_xla_within_half_a_percent():
    kw = dict(upsample_rates=(4, 2), upsample_kernel_sizes=(8, 4), upsample_initial_channel=64)
    voc = FlaxHiFiGAN(cfg=jax_cfglib.HiFiGANConfig(**kw))
    params = voc.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80)))
    xla = _xla_flops(jax.jit(voc.apply).lower(params, jnp.zeros((1, 64, 80))))
    ours = mfu.hifigan_count(config.HiFiGANConfig(**kw), 1, 64).total
    assert abs(ours / xla - 1) < 5e-3, (ours, xla)
    # an MRF stage of v1 is 252·B·T·C² (the JAX tool's docstring)
    assert mfu.mrf_stage_flops(config.HiFiGANConfig(), 128, 8, 4096) == 252 * 8 * 4096 * 128 ** 2


def test_encoder_and_decoder_counts_against_xla(bridged, steps=2):
    jp, pp = bridged
    text, m_bucket = "The quick brown fox jumped over the lazy dog, and everyone cheered.", 128
    x, xl, _, tb = jp.encode_texts([text])
    spk = np.asarray([1], np.int32)
    stage_a = jp._get_stage_a(tb, 1)
    enc_xla = _xla_flops(stage_a.lower(jp.params, x, xl, spk, np.float32(1.0)))
    enc = [np.asarray(v) if v is not None else None for v in
           jax.device_get(stage_a(jp.params, x, xl, spk, np.float32(1.0)))]
    stage_b = jp._get_stage_b(tb, m_bucket, 1, steps, denoise=False, keep_mel=True, vocode=False)
    dec_xla = _xla_flops(stage_b.lower(jp.params, jp.vocoder_params, *enc, np.float32(0.667),
                                       jax.random.PRNGKey(0), np.float32(0.00025)))
    xt, xlt, _, _ = pp.encode_texts([text])
    ours = mfu.synthesis_count(pp, torch.from_numpy(xt), torch.from_numpy(xlt), torch.tensor([1]), m_bucket, steps,
                               vocoder=False)
    for name, theirs in (("encoder", enc_xla), ("decoder", dec_xla)):
        assert 0.80 <= ours[name].total / theirs <= 1.0, (name, ours[name].total, theirs)


class StubEngine:
    """A fixed service time per request on a pool; the `stall_at`-th submit
    blocks for `stall_s` (a stalled engine holds its caller)."""

    def __init__(self, service_s: float, stall_at: int = 0, stall_s: float = 0.0):
        self.pool = ThreadPoolExecutor(32)
        self.service_s, self.stall_at, self.stall_s = service_s, stall_at, stall_s
        self.n = 0
        self.lock = threading.Lock()

    def _serve(self):
        time.sleep(self.service_s)
        return SimpleNamespace(wav=np.zeros(16, np.float32), sample_rate=22050)

    def submit(self, text, spk=0, n_timesteps=10, **kw):
        with self.lock:
            self.n += 1
            n = self.n
        if n == self.stall_at:
            time.sleep(self.stall_s)
        return self.pool.submit(self._serve)

    def stats(self):
        return {"requests": self.n, "batches": self.n, "batched_rows": self.n, "wait_s_sum": 0.0}


def test_open_loop_rate_excludes_the_drain():
    eng = StubEngine(service_s=0.3)
    pt = serving.measure_open_loop(eng, rate=20.0, window_s=1.0, seed=0)
    eng.pool.shutdown()
    assert pt["requests"] == eng.n > 5
    assert pt["achieved_rate_per_s"] == pt["requests"] / 1.0
    assert 0.0 < pt["drain_s"] <= 0.45  # the last requests' service, after the window
    twin_rate = pt["requests"] / (1.0 + pt["drain_s"])  # tools/bench_serving.py:140 divided by the drain too
    assert pt["achieved_rate_per_s"] > twin_rate
    assert pt["p50_ms"] >= 290 and pt["late_ms_max"] < 100


def test_open_loop_stall_shows_in_the_latency_behind_it():
    eng = StubEngine(service_s=0.05, stall_at=4, stall_s=0.5)
    pt = serving.measure_open_loop(eng, rate=20.0, window_s=1.5, seed=1)
    eng.pool.shutdown()
    assert pt["late_ms_max"] >= 400  # the submitter ran late behind the stall ...
    assert pt["max_ms"] >= 400 + 50  # ... and the requests due during it count the wait
    assert pt["p50_ms"] < pt["max_ms"] / 2


def test_f4_flag_set_only_when_the_headline_and_its_row_differ():
    rng = np.random.default_rng(0)
    headline = list(0.0117 + 1e-4 * rng.standard_normal(10))
    row = list(0.00894 + 1e-4 * rng.standard_normal(5))  # BENCH_r05.json's pair
    apart = synthesis.headline_vs_row(headline, row)
    assert apart["differ"] and apart["ratio"] > 1.2
    alike = synthesis.headline_vs_row(headline, list(0.0117 + 1e-4 * rng.standard_normal(5)))
    assert not alike["differ"]
