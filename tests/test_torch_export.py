"""The port's export artifact (``emojivoice_tpu_torch.inference.export``):
``torch.export`` programs per bucket key, the bundle and its runner.

At the tiny config (``tests/test_pipeline.py::tiny_root``, weights carried
over from a flax init through ``io/from_jax.py``, ``device="cpu"``), text
bucket 64, mel buckets (64, 128), batches (1, 2) and 2 Euler steps, as
``tests/test_export_and_obs.py`` exports the JAX bundle.

Tolerances: an exported, saved and reloaded synthesis program against the
JAX model's chain (``MatchaTTS.synthesise`` → HiFi-GAN → denoiser, the same
weights and the same injected noise) within atol 1e-4 on the float waveform
and one pcm16 step (the tolerances of ``tests/test_torch_denoiser_pipeline.py``),
mel and duration lengths equal.  A bundle row against the port's live fused
call with that row's seed at the same mel bucket: equal to the bit (one
device, the same ops on the same inputs).  A row inside a batch-2 program
against the batch-1 program: atol 1e-5, the JAX contract (batch shapes sum
in other orders).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emojivoice_tpu.models import MatchaTTS as FlaxMatcha
from emojivoice_tpu.vocoder import Denoiser as JaxDenoiser
from emojivoice_tpu.vocoder import HiFiGANGenerator as FlaxHiFiGAN
from emojivoice_tpu_torch.inference import export
from emojivoice_tpu_torch.inference.export import (BundleSynthesisPipeline, ExportedSynthesizer, LoadedBundle,
                                                   export_bundle, main_run)
from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
from emojivoice_tpu_torch.io.from_jax import hifigan_state_dict_from_flax, matcha_state_dict_from_flax
from tests.test_pipeline import tiny_root
from tests.test_torch_serving import flax_tiny_params, port_root

torch.set_num_threads(2)

KW = dict(cleaners=("basic_cleaners",), mel_buckets=(64, 128), text_buckets=(64,))
STEPS, STRENGTH = 2, 0.00025
LONG = "hello there"  # 69 predicted frames at speaker 1: mel bucket 128, past 64
SHORT = "a b c"  # 23 frames: mel bucket 64


@pytest.fixture(scope="module")
def weights():
    jax_root, params, voc_params = flax_tiny_params()
    root = port_root(jax_root)
    pipe = SynthesisPipeline.from_state_dicts(
        root.model, matcha_state_dict_from_flax(params, root.model), root.vocoder,
        hifigan_state_dict_from_flax(voc_params, root.vocoder), device="cpu", **KW)
    return jax_root, params, voc_params, pipe


@pytest.fixture(scope="module")
def pipe(weights):
    return weights[-1]


@pytest.fixture(scope="module")
def bundle_dir(pipe, tmp_path_factory):
    """f32 programs over batches (1, 2) x text 64 x mel (64, 128)."""
    d = tmp_path_factory.mktemp("export") / "bundle"
    export_bundle(pipe, str(d), text_buckets=[64], mel_buckets=[64, 128], batches=(1, 2), n_timesteps=STEPS)
    return d


@pytest.fixture(scope="module")
def pcm_dir(pipe, tmp_path_factory):
    """pcm16 programs at batch 1 and mel bucket 128 only."""
    d = tmp_path_factory.mktemp("export") / "pcm"
    export_bundle(pipe, str(d), text_buckets=[64], mel_buckets=[128], batches=(1,), n_timesteps=STEPS, pcm16=True)
    return d


@pytest.fixture(scope="module")
def bundle(bundle_dir):
    """One runner for the tests that do not count its loads: each program is loaded once."""
    return LoadedBundle(str(bundle_dir), device="cpu")


def live(pipe, texts, spks, seeds, mel_bucket, **kw):
    """The live pipeline's fused per-row-seed call at `mel_bucket`."""
    return pipe.synthesise(texts, spks=spks, n_timesteps=STEPS, seed=list(seeds), fused=True,
                           fused_mel_bucket=mel_bucket, **kw)


def test_exported_program_matches_the_jax_chain(weights, bundle_dir, pcm_dir, rng):
    """The synthesis program, saved and reloaded, against the body of the
    JAX ``export_synthesis`` program with the noise injected; the duration
    program against the JAX ``encode_text``."""
    jax_root, params, voc_params, pipe = weights
    texts, spks, m = ["hello there", "a longer sentence here"], [1, 3], 128
    x, xl, _, _ = pipe.encode_texts(texts)
    z = rng.normal(size=(2, m, 12)).astype(np.float32)  # unscaled: the programs multiply by the temperature
    model, voc = FlaxMatcha(cfg=jax_root.model), FlaxHiFiGAN(cfg=jax_root.vocoder)
    denoiser = JaxDenoiser(lambda mel: voc.apply(voc_params, mel), mode="zeros", num_mels=12)

    @jax.jit
    def jax_chain(x, xl, spks, z):
        out = model.apply(params, x, xl, m, STEPS, 0.667, spks, 1.0, None, z * 0.667, method=FlaxMatcha.synthesise)
        wav = denoiser(voc.apply(voc_params, out["mel"]), STRENGTH)
        y_lengths = model.apply(params, x, xl, spks, 1.0, method=FlaxMatcha.encode_text)[2]
        return out["mel_lengths"], wav, (jnp.clip(wav, -1.0, 1.0) * 32767.0).astype(jnp.int16), y_lengths

    ml_j, wav_j, pcm_j, yl_j = jax.device_get(jax_chain(jnp.asarray(x, jnp.int32), jnp.asarray(xl, jnp.int32),
                                                        jnp.asarray(spks, jnp.int32), jnp.asarray(z)))
    args = (torch.from_numpy(x), torch.from_numpy(xl), torch.tensor(spks), torch.tensor(1.0))
    with torch.inference_mode():
        wav, ml = export._load_program(bundle_dir / f"synth_b2_t64_m{m}.pt2")(*args, torch.tensor(0.667),
                                                                              torch.from_numpy(z))
        y_lengths = export._load_program(bundle_dir / "dur_b2_t64.pt2")(*args)
    np.testing.assert_array_equal(ml.numpy(), ml_j)
    np.testing.assert_array_equal(y_lengths.numpy(), yl_j)
    assert wav.shape == wav_j.shape == (2, m * 16)
    np.testing.assert_allclose(wav.numpy(), wav_j, atol=1e-4)
    export_bundle(pipe, str(pcm_dir.parent / "pcm_b2"), text_buckets=[64], mel_buckets=[m], batches=(2,),
                  n_timesteps=STEPS, pcm16=True)
    with torch.inference_mode():
        pcm, _ = export._load_program(pcm_dir.parent / "pcm_b2" / f"synth_b2_t64_m{m}.pt2")(
            *args, torch.tensor(0.667), torch.from_numpy(z))
    assert pcm.dtype == torch.int16
    assert np.abs(pcm.numpy().astype(np.int32) - pcm_j.astype(np.int32)).max() <= 1


def test_exported_synthesizer_reproduces_the_live_call(pipe, bundle_dir):
    synth = ExportedSynthesizer(str(bundle_dir / "synth_b1_t64_m128"), device="cpu")
    assert synth.meta["n_timesteps"] == STEPS and synth.meta["with_vocoder"] and synth.meta["device"] == "cpu"
    x, xl, _, _ = pipe.encode_texts([LONG])
    wav, mel_lengths = synth(x, xl, [1], seed=3)
    want = live(pipe, [LONG], [1], [3], 128)[0]
    assert int(mel_lengths[0]) == want.mel_length
    np.testing.assert_array_equal(wav[0, :want.mel_length * 16], want.wav)


def test_export_bundle_roundtrip(pipe, bundle_dir, bundle):
    """The manifest over (batch x text x mel); the runner pads, picks the
    program through the duration program, chunks beyond the largest batch,
    and every row equals the live per-row-seed call to the bit."""
    meta = json.loads((bundle_dir / "manifest.json").read_text())
    assert meta["format"] == export.FORMAT and meta["device"] == "cpu" and meta["rng_per_row"] is True
    assert len(meta["programs"]) == 4 and {p["synth"] for p in meta["programs"]} >= {"synth_b2_t64_m64"}
    for p in meta["programs"]:
        assert (bundle_dir / f"{p['synth']}.pt2").exists() and (bundle_dir / f"{p['durations']}.pt2").exists()

    results, timings = bundle.synthesise([LONG], spks=[1], seed=5)
    assert (timings["batch"], timings["text_bucket"], timings["mel_bucket"]) == (1, 64, 128)
    want = live(pipe, [LONG], [1], [5], 128)[0]
    assert results[0]["mel_length"] == want.mel_length and results[0]["cleaned_text"] == want.cleaned_text
    np.testing.assert_array_equal(results[0]["wav"], want.wav)
    results, timings = bundle.synthesise([SHORT], spks=[1], seed=5)
    assert timings["mel_bucket"] == 64
    np.testing.assert_array_equal(results[0]["wav"], live(pipe, [SHORT], [1], [5], 64)[0].wav)

    # more texts than the largest exported batch: served in chunks, text k drawing the stream of seed + k
    texts3 = ["a b c", "d e f", "g h i"]
    results3, timings3 = bundle.synthesise(texts3, spks=[0, 1, 2], seed=40)
    assert len(results3) == 3 and timings3["chunks"] == 2
    last, t_last = bundle.synthesise(texts3[2:], spks=[2], seed=42)
    np.testing.assert_array_equal(results3[2]["wav"], last[0]["wav"])

    # the batch-2 programs: pad rows trimmed, each row the live per-row-seed row
    texts = ["first one", "second longer text"]
    results2, timings2 = bundle.synthesise(texts, spks=[0, 2], seed=[7, 9])
    assert timings2["batch"] == 2 and len(results2) == 2
    for r, w in zip(results2, live(pipe, texts, [0, 2], [7, 9], timings2["mel_bucket"])):
        np.testing.assert_array_equal(r["wav"], w.wav)


def test_bundle_per_row_seeds_reproduce_direct_calls(bundle):
    """A text served inside a merged batch draws its own noise: the batch-2
    row against the batch-1 call with its seed at the same mel bucket."""
    texts = [LONG, "a different utterance"]
    merged, t = bundle.synthesise(texts, spks=[1, 2], seed=[11, 22])
    assert t["mel_bucket"] == 128
    solo_a, _ = bundle.synthesise([texts[0]], spks=[1], seed=[11], mel_bucket=128)
    solo_b, _ = bundle.synthesise([texts[1]], spks=[2], seed=[22], mel_bucket=128)
    np.testing.assert_allclose(merged[0]["wav"], solo_a[0]["wav"], atol=1e-5)
    np.testing.assert_allclose(merged[1]["wav"], solo_b[0]["wav"], atol=1e-5)
    merged2, _ = bundle.synthesise(texts, spks=[1, 2], seed=7)  # int seed: text k draws the stream of seed + k
    solo2, _ = bundle.synthesise([texts[1]], spks=[2], seed=[8], mel_bucket=128)
    np.testing.assert_allclose(merged2[1]["wav"], solo2[0]["wav"], atol=1e-5)
    with pytest.raises(ValueError, match="seeds"):
        bundle.synthesise(texts, spks=[1, 2], seed=[1, 2, 3])


def test_pcm16_bundle_quantizes_on_device(pipe, bundle, pcm_dir, tmp_path):
    meta = json.loads((pcm_dir / "manifest.json").read_text())
    assert meta["pcm16"] is True
    f32, _ = bundle.synthesise([LONG], spks=[1], seed=5, mel_bucket=128)
    pcm, _ = LoadedBundle(str(pcm_dir), device="cpu").synthesise([LONG], spks=[1], seed=5)
    assert pcm[0]["wav"].dtype == np.int16
    ref = (np.clip(f32[0]["wav"], -1.0, 1.0) * 32767.0).astype(np.int16)
    assert np.abs(pcm[0]["wav"].astype(np.int32) - ref.astype(np.int32)).max() <= 1
    # the live pipeline's pcm16 mode: the same on-device cast
    want = live(pipe, [LONG], [1], [5], 128, pcm16=True)[0].wav
    np.testing.assert_array_equal(pcm[0]["wav"].astype(np.float32) / 32767.0, want)

    # the runner CLI writes the int16 samples as a PCM wav as they are
    assert main_run(["--cpu", "--bundle", str(pcm_dir), "--text", LONG, "--spk", "1", "--seed", "5",
                     "--output_folder", str(tmp_path / "out")]) == 0
    from scipy.io import wavfile

    sr, data = wavfile.read(tmp_path / "out" / "utterance_001.wav")
    assert sr == 22050 and data.dtype == np.int16
    np.testing.assert_array_equal(data, pcm[0]["wav"])


def test_bundle_skips_duration_program_when_bucket_known(bundle_dir, pcm_dir):
    """The duration program only chooses a mel bucket: a bundle with one mel
    bucket, or a pinned one, skips it; a pinned bucket that the predicted
    length saturates is served again at the duration program's pick."""
    def counting(bundle):
        loads = []
        real = bundle._load
        bundle._load = lambda name: (loads.append(name), real(name))[1]
        return loads

    one = LoadedBundle(str(pcm_dir), device="cpu")
    loads = counting(one)
    results, timings = one.synthesise([LONG], spks=[1], seed=5)
    assert not [n for n in loads if n.startswith("dur_")]
    assert timings["mel_bucket"] == 128 and results[0]["mel_length"] > 0

    two = LoadedBundle(str(bundle_dir), device="cpu")
    loads = counting(two)
    res_dur, t_dur = two.synthesise([LONG], spks=[1], seed=5)
    assert "dur_b1_t64" in loads and t_dur["mel_bucket"] == 128
    loads.clear()
    res_pin, t_pin = two.synthesise([LONG], spks=[1], seed=5, mel_bucket=128)
    assert not [n for n in loads if n.startswith("dur_")] and t_pin["mel_bucket"] == 128
    np.testing.assert_array_equal(res_pin[0]["wav"], res_dur[0]["wav"])

    # pinned at 64, the durations overflow it: escalated to 128 instead of truncated audio
    loads.clear()
    res_esc, t_esc = two.synthesise([LONG], spks=[1], seed=5, mel_bucket=64)
    assert t_esc["mel_bucket"] == 128 and loads == ["synth_b1_t64_m64", "dur_b1_t64", "synth_b1_t64_m128"]
    np.testing.assert_array_equal(res_esc[0]["wav"], res_dur[0]["wav"])
    with pytest.raises(ValueError, match="not in exported grid"):
        two.synthesise(["hello"], spks=[1], mel_bucket=999)


def test_export_without_vocoder_emits_mel_programs(pipe, tmp_path):
    """A pipeline without a vocoder (and so without a denoiser) serves mels
    only and exports mel programs; the serving surface refuses such a bundle."""
    mel_pipe = SynthesisPipeline.from_random(port_root(tiny_root()), with_vocoder=False, device="cpu", **KW)
    assert mel_pipe.vocoder is None and mel_pipe.denoiser is None and mel_pipe.vocoder_cfg is None
    with pytest.raises(ValueError, match="no vocoder"):
        mel_pipe.synthesise(["mel only"], spks=[0], n_timesteps=STEPS)
    direct = mel_pipe.synthesise(["mel only"], spks=[0], n_timesteps=STEPS, seed=[3], vocode=False, fused=True,
                                 fused_mel_bucket=64)[0]
    manifest = export_bundle(mel_pipe, str(tmp_path / "mel"), text_buckets=[64], mel_buckets=[64], batches=(1,),
                             n_timesteps=STEPS)
    meta = json.loads(manifest.read_text())
    assert meta["with_vocoder"] is False and meta["upsample"] is None and meta["pcm16"] is False
    results, _ = LoadedBundle(str(tmp_path / "mel"), device="cpu").synthesise(["mel only"], spks=[0], seed=3)
    assert results[0]["mel"].shape == (direct.mel_length, 12) and "wav" not in results[0]
    np.testing.assert_array_equal(results[0]["mel"], direct.mel)
    with pytest.raises(ValueError, match="no_vocoder"):
        BundleSynthesisPipeline(str(tmp_path / "mel"), device="cpu")
    # a pipeline with a vocoder exports mel programs on request
    export_bundle(pipe, str(tmp_path / "asked"), text_buckets=[64], mel_buckets=[64], batches=(1,),
                  n_timesteps=STEPS, with_vocoder=False)
    assert json.loads((tmp_path / "asked" / "manifest.json").read_text())["with_vocoder"] is False
    with pytest.raises(ValueError, match="vocoder_cfg and vocoder"):
        SynthesisPipeline(mel_pipe.model_cfg, mel_pipe.model, vocoder_cfg=pipe.vocoder_cfg, device="cpu")


def test_run_exported_cli(bundle_dir, tmp_path):
    f = tmp_path / "texts.txt"
    f.write_text("hello world|1\nanother line|2\n\n")
    out_dir = tmp_path / "wavs"
    assert main_run(["--cpu", "--bundle", str(bundle_dir), "--file", str(f), "--output_folder", str(out_dir)]) == 0
    wavs = sorted(out_dir.glob("*.wav"))
    assert len(wavs) == 2
    from scipy.io import wavfile

    sr, data = wavfile.read(wavs[0])
    assert sr == 22050 and data.size > 0
    with pytest.raises(SystemExit):
        main_run(["--cpu", "--bundle", str(bundle_dir)])  # neither --text nor --file


def test_run_exported_speaking_rate_matches_live(bundle_dir, bundle, tmp_path):
    """--speaking_rate passes straight through as length_scale, as the live CLI does."""
    out_dir = tmp_path / "wavs"
    assert main_run(["--cpu", "--bundle", str(bundle_dir), "--text", "rate check here", "--spk", "1",
                     "--speaking_rate", "0.7", "--seed", "5", "--output_folder", str(out_dir)]) == 0
    direct, _ = bundle.synthesise(["rate check here"], spks=[1], length_scale=0.7, seed=5)
    slow, _ = bundle.synthesise(["rate check here"], spks=[1], seed=5)
    from scipy.io import wavfile

    sr, wav = wavfile.read(sorted(out_dir.glob("*.wav"))[0])
    want = direct[0]["wav"]
    assert wav.dtype == np.float32 and wav.size == want.size < slow[0]["wav"].size
    np.testing.assert_allclose(wav, np.clip(want, -1.0, 1.0), atol=1e-6)


def test_main_export_writes_a_bundle_the_runner_serves(pipe, monkeypatch, tmp_path):
    """``emojivoice-export-bundle-torch --cpu --random_init`` (the preset is
    full width, so from_random hands over the tiny pipeline here)."""
    seen = {}

    def tiny_from_random(cls, device="cuda", **kw):
        seen["device"] = device
        return pipe

    monkeypatch.setattr(SynthesisPipeline, "from_random", classmethod(tiny_from_random))
    out = tmp_path / "cli_bundle"
    assert export.main_export(["--cpu", "--random_init", "--output_dir", str(out), "--steps", "2",
                               "--text_buckets", "64", "--mel_buckets", "64", "--batches", "1"]) == 0
    assert seen["device"] == "cpu"
    meta = json.loads((out / "manifest.json").read_text())
    assert (meta["n_timesteps"], meta["batches"], meta["mel_buckets"], meta["device"]) == (2, [1], [64], "cpu")
    assert main_run(["--cpu", "--bundle", str(out), "--text", SHORT, "--output_folder", str(tmp_path / "o")]) == 0
    with pytest.raises(SystemExit):
        export.main_export(["--cpu", "--output_dir", str(tmp_path / "none")])  # no weights named


def test_a_jax_bundle_is_refused_by_name(tmp_path):
    (tmp_path / "manifest.json").write_text(json.dumps({"format": "emojivoice-export-bundle-v1", "platforms": ["tpu"]}))
    with pytest.raises(ValueError, match="emojivoice-export-bundle-v1"):
        LoadedBundle(str(tmp_path), device="cpu")


def test_programs_carry_the_kept_rope_tables(bundle_dir):
    """The exporter runs the model once before the trace, so the RoPE tables
    enter each program as two constants (cos, sin) made once, which on the
    card lie on the device: made inside the trace they would be host tensors
    copied up, with a wait, at every layer of every run."""
    from emojivoice_tpu_torch.ops import rope

    for name in ("synth_b1_t64_m64", "dur_b2_t64"):
        consts = list(torch.export.load(bundle_dir / f"{name}.pt2").constants.values())
        tables = [c for c in consts if isinstance(c, torch.Tensor) and c.dim() == 2 and c.shape[0] == 64]
        assert len(tables) == 2, (name, [tuple(c.shape) for c in consts if isinstance(c, torch.Tensor)])
        kept = next(v for k, v in rope._TABLES.items() if k[0] == 64)
        assert {torch.equal(t, kept[0]) or torch.equal(t, kept[1]) for t in tables} == {True}
