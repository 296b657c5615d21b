"""The pipeline's precision switches against the JAX pipeline's, on the CPU
at the tiny config (weights carried by ``io/from_jax.py``, 2 Euler steps).

Noise: both packages draw their own from a seed (threefry against Philox),
so where the JAX output is compared the same normal draw is handed to both,
as ``tests/test_torch_denoiser_pipeline.py`` does: the port's
``synthesis_noise`` is patched to return it, and the JAX side runs its own
stage functions' casts (``_cast_in``, ``_vocode``, ``_cast_out``) on its model
with that draw.

Tolerances are the JAX package's own for these switches:
* ``vocoder_dtype=bf16``: the mel within 1e-5 of the f32 mel, the waveform
  within 2e-2 of f32's and of the JAX pipeline's bf16 vocoder on the same mel
  (``tests/test_pipeline.py::test_vocoder_bf16_close_to_f32``).  The JAX
  pipeline vocodes every conv in bf16 through XLA, the port only K1's tap
  products (``vocoder/hifigan.py``), so the two differ by more than the
  kernel's bf16 mode alone;
* ``compute_dtype=bf16``: ``mel_length`` within 2 and mel MAE below 0.1
  (``tests/test_export_and_obs.py::test_bf16_pipeline_close_to_f32``);
* streamed against monolithic: 1e-6, the f32 contract
  (``test_torch_streaming_longform.py``), which holds within bf16 mode; an
  engine row against the direct call of the same batch: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from emojivoice_tpu.inference.pipeline import SynthesisPipeline as JaxPipeline
from emojivoice_tpu.models import MatchaTTS as FlaxMatcha
from emojivoice_tpu.utils.buckets import pick_bucket as jax_pick_bucket
from emojivoice_tpu.utils.masks import fix_len_compatibility as jax_fix_len
from emojivoice_tpu_torch.inference import pipeline as pipeline_mod
from emojivoice_tpu_torch.inference.serving import BatchingEngine
from emojivoice_tpu_torch.inference.streaming import StreamingVocoder
from emojivoice_tpu_torch.io.from_jax import hifigan_state_dict_from_flax, matcha_state_dict_from_flax
from emojivoice_tpu_torch.vocoder import hifigan
from tests.test_torch_serving import flax_tiny_params, port_root
from tests.test_torch_streaming_longform import receptive_field_frames

torch.set_num_threads(2)

BF16 = torch.bfloat16
MEL_BUCKETS, TEXT_BUCKETS = (64, 128, 256), (64, 128)
TEXT, SPK, STEPS, TEMP = "the precision switches", 1, 2, 0.667


@pytest.fixture(scope="module")
def pipes():
    """The JAX pipeline's weights; the port's pipelines on them in f32, with
    ``vocoder_dtype`` and with ``compute_dtype`` bf16."""
    jax_root, params, voc_params = flax_tiny_params(0)
    root = port_root(jax_root)
    sds = (matcha_state_dict_from_flax(params, root.model), hifigan_state_dict_from_flax(voc_params, root.vocoder))

    def port(**kw):
        return pipeline_mod.SynthesisPipeline.from_state_dicts(
            root.model, sds[0], root.vocoder, sds[1], cleaners=("basic_cleaners",), mel_buckets=MEL_BUCKETS,
            text_buckets=TEXT_BUCKETS, device="cpu", **kw)

    return dict(jax_root=jax_root, params=params, voc_params=voc_params, f32=port(),
                vocoder=port(vocoder_dtype=BF16), compute=port(compute_dtype=BF16))


def _jax_pipeline(pipes, **kw):
    root = pipes["jax_root"]
    return JaxPipeline(root.model, pipes["params"], root.vocoder, pipes["voc_params"], cleaners=("basic_cleaners",),
                       mel_buckets=MEL_BUCKETS, text_buckets=TEXT_BUCKETS, **kw)


@pytest.fixture
def noise(monkeypatch):
    """One normal draw for both packages: the port's synthesis noise patched to it."""
    z = (np.random.default_rng(5).normal(size=(1, MEL_BUCKETS[-1], 12)) * TEMP).astype(np.float32)
    monkeypatch.setattr(pipeline_mod, "synthesis_noise",
                        lambda seed, b, m_bucket, n_feats, temperature, device: torch.from_numpy(z[:b, :m_bucket]))
    return z


def test_vocoder_dtype_runs_only_the_vocoder_in_bf16(pipes, monkeypatch):
    f32, b16 = (pipes[k].synthesise([TEXT], spks=[SPK], n_timesteps=STEPS, seed=3)[0] for k in ("f32", "vocoder"))
    assert b16.wav.dtype == np.float32 and b16.mel.dtype == np.float32
    assert b16.mel_length == f32.mel_length
    np.testing.assert_allclose(b16.mel, f32.mel, atol=1e-5)  # the acoustic path untouched
    assert 0 < float(np.abs(b16.wav - f32.wav).max()) < 2e-2

    # the JAX pipeline's vocoder_dtype=bf16 vocoding of the same mel
    jp = _jax_pipeline(pipes, vocoder_dtype=jnp.bfloat16)
    mel = b16.mel[None]
    ref = np.asarray(jp._vocode(pipes["voc_params"], jnp.asarray(mel)))
    got = pipes["vocoder"]._vocode(torch.from_numpy(mel)).numpy()
    assert got.shape == ref.shape and 0 < float(np.abs(got - ref).max()) < 2e-2

    # every MRF stage took K1's bf16 operands; the denoiser's probe ran the f32 vocoder
    seen = []
    real = hifigan.mrf_stage
    monkeypatch.setattr(hifigan, "mrf_stage", lambda x, w, *a: seen.append(w[0][0].dtype) or real(x, w, *a))
    pipes["vocoder"].synthesise([TEXT], spks=[SPK], n_timesteps=STEPS, seed=3)
    assert seen == [BF16] * len(pipes["jax_root"].vocoder.upsample_rates)
    assert torch.equal(pipes["vocoder"].denoiser.bias_spec, pipes["f32"].denoiser.bias_spec)


def _jax_compute_bf16(pipes, fused: bool, z):
    """The JAX pipeline's compute_dtype=bf16 request with the draw `z`: stage
    A in f32 and stage B on cast inputs (two-stage), or everything cast
    (fused), then its vocoder on the cast weights, as ``_get_stage_b`` /
    ``_get_fused`` compute it."""
    jp = _jax_pipeline(pipes, compute_dtype=jnp.bfloat16)
    params, voc_params = pipes["params"], pipes["voc_params"]
    x, xl, _, _ = jp.encode_texts([TEXT])
    spks = np.array([SPK], np.int32)
    if fused:
        out = jax.jit(lambda p, zz: jp.model.apply(jp._cast_in(p), x, xl, 128, STEPS, TEMP, spks, 1.0, None, zz,
                                                   method=FlaxMatcha.synthesise))(params, z[:, :128])
    else:
        mu_x, w_ceil, y_lengths, x_mask, spk_e = jp.model.apply(params, x, xl, spks, 1.0,
                                                                method=FlaxMatcha.encode_text)
        m_bucket = jax_pick_bucket(jax_fix_len(int(np.max(y_lengths))), MEL_BUCKETS)

        def stage_b(p, mu_x, x_mask, spk_e, zz):
            p, mu_x, x_mask, spk_e = jp._cast_in((p, mu_x, x_mask, spk_e))
            return jp.model.apply(p, mu_x, w_ceil, y_lengths, x_mask, spk_e, m_bucket, STEPS, TEMP, None, zz,
                                  method=FlaxMatcha.decode_mel)
        out = jax.jit(stage_b)(params, mu_x, x_mask, spk_e, z[:, :m_bucket])
    wav = jp._vocode(jp._cast_in(voc_params), out["mel"])
    res = jax.device_get(jp._cast_out({"mel": out["mel"], "wav": wav, "mel_lengths": out["mel_lengths"]}))
    ml = int(res["mel_lengths"][0])
    return ml, np.asarray(res["mel"][0][:ml]), np.asarray(res["wav"][0])


@pytest.mark.parametrize("fused", [False, True], ids=["two_stage", "fused"])
def test_compute_dtype_matches_jax_bf16_and_port_f32(pipes, noise, fused):
    kw = dict(spks=[SPK], n_timesteps=STEPS, seed=0, fused=fused, fused_mel_bucket=128 if fused else None,
              denoiser_strength=0.0)
    got = pipes["compute"].synthesise([TEXT], **kw)[0]
    f32 = pipes["f32"].synthesise([TEXT], **kw)[0]
    ml_j, mel_j, wav_j = _jax_compute_bf16(pipes, fused, noise)
    assert got.wav.dtype == np.float32 and got.mel.dtype == np.float32
    assert np.isfinite(got.wav).all() and got.wav.shape == (got.mel_length * 16,)
    if not fused:  # stage A ran in f32 in both: the same lengths
        assert got.mel_length == f32.mel_length
    for name, (ml, mel) in (("jax bf16", (ml_j, mel_j)), ("port f32", (f32.mel_length, f32.mel))):
        assert abs(got.mel_length - ml) <= 2, name
        n = min(got.mel_length, ml)
        mae = float(np.abs(got.mel[:n] - mel[:n]).mean())
        assert 0 < mae < 0.1, (name, mae)
    assert wav_j.dtype == np.float32 and np.isfinite(wav_j).all()


@pytest.mark.parametrize("fused", [False, True], ids=["two_stage", "fused"])
def test_compute_dtype_really_computes_in_bf16(pipes, fused):
    """Every Linear and Conv of the U-Net takes bf16 inputs (PyTorch would
    silently promote bf16·f32 to f32, e.g. through an f32 mask, and an f32 path
    would pass every tolerance above); so does the encoder's in fused mode,
    while in two-stage mode the encoder runs on the f32 model.  The time
    embedding's MLP is f32 by design, as in the JAX package."""
    pipe = pipes["compute"]
    seen, handles = {}, []

    def watch(module, prefix, want):
        for name, m in module.named_modules():
            if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)) and "time_mlp" not in name:
                def hook(mod, args, key=f"{prefix}.{name}"):
                    seen.setdefault(key, set()).add(args[0].dtype)
                handles.append(m.register_forward_pre_hook(hook))
                seen.setdefault(f"{prefix}.{name}", set())
                want[f"{prefix}.{name}"] = None

    expect_bf16, expect_f32, expect_idle = {}, {}, {}
    watch(pipe.compute_model.decoder, "decoder", expect_bf16)
    watch(pipe.compute_model.encoder, "encoder_bf16", expect_bf16 if fused else expect_idle)
    watch(pipe.model.encoder, "encoder_f32", expect_idle if fused else expect_f32)
    try:
        pipe.synthesise([TEXT], spks=[SPK], n_timesteps=STEPS, seed=0, fused=fused,
                        fused_mel_bucket=128 if fused else None)
    finally:
        for h in handles:
            h.remove()
    assert len(expect_bf16) > 20
    assert all(seen[k] == {BF16} for k in expect_bf16), {k: seen[k] for k in expect_bf16 if seen[k] != {BF16}}
    assert all(seen[k] == {torch.float32} for k in expect_f32)
    assert all(not seen[k] for k in expect_idle)
    assert all(p.dtype == torch.float32 for p in pipe.model.parameters())  # parameters at rest stay f32
    # the time MLP holds the bf16 values of its weights as f32, so a request casts none of them
    mlp = pipe.compute_model.decoder.estimator.time_mlp
    for (name, p), ref in zip(mlp.named_parameters(), pipe.model.decoder.estimator.time_mlp.parameters()):
        assert p.dtype == torch.float32 and torch.equal(p, ref.to(BF16).float()), name


def test_streaming_and_the_engine_follow_the_mode(pipes, rng):
    """Chunked streaming through the pipeline's ``_vocode`` and a row inside an
    engine batch give what the direct calls give, in bf16 mode."""
    pipe = pipes["vocoder"]
    mel = torch.from_numpy(rng.normal(size=(128, 12)).astype(np.float32) * 2 - 6)
    mono = pipe._vocode(mel[None])[0].numpy()
    assert float(np.abs(mono - pipes["f32"]._vocode(mel[None])[0].numpy()).max()) > 0  # really the bf16 mode
    sv = StreamingVocoder(pipe.vocoder, chunk_frames=32, overlap=receptive_field_frames(pipe.vocoder_cfg),
                          vocode_fn=pipe._vocode)
    streamed = np.concatenate(list(sv.stream(mel, mel_length=100)))
    np.testing.assert_allclose(streamed, mono[: len(streamed)], atol=1e-6)

    with BatchingEngine(pipe, max_batch=2, max_wait_ms=2000, batch_buckets=(1, 2), pcm16=False) as eng:
        futs = [eng.submit(TEXT, spk=SPK, n_timesteps=STEPS, seed=s) for s in (11, 12)]
        merged = [f.result(timeout=120) for f in futs]
        assert eng.stats()["batches"] == 1
    # the direct call of the same batch, to the bit; the batch-1 call sums its convs in another order, and
    # within bf16 mode that can move an activation across a rounding boundary: held at the bf16 bound only
    direct = pipe.synthesise([TEXT, TEXT], spks=[SPK, SPK], n_timesteps=STEPS, seed=[11, 12])
    for m, d in zip(merged, direct):
        np.testing.assert_array_equal(m.wav, d.wav)
    single = pipe.synthesise([TEXT], spks=[SPK], n_timesteps=STEPS, seed=11)[0]
    assert float(np.abs(merged[0].wav - single.wav).max()) < 2e-2


def test_switches_are_checked_and_the_denoiser_mode_passes_through(pipes):
    root = port_root(pipes["jax_root"])
    with pytest.raises(ValueError, match="compute_dtype"):
        pipeline_mod.SynthesisPipeline.from_random(root, device="cpu", compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="vocoder_dtype"):
        pipeline_mod.SynthesisPipeline.from_random(root, device="cpu", vocoder_dtype=torch.float64)
    with pytest.raises(ValueError, match="not supported"):
        pipeline_mod.SynthesisPipeline.from_random(root, device="cpu", denoiser_mode="ones")
    normal = pipeline_mod.SynthesisPipeline.from_random(root, device="cpu", denoiser_mode="normal")
    zeros = pipeline_mod.SynthesisPipeline.from_random(root, device="cpu")
    assert not torch.equal(normal.denoiser.bias_spec, zeros.denoiser.bias_spec)
    assert zeros.compute_model is zeros.model and zeros.vocode_dtype == torch.float32
