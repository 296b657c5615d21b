"""Port's denoiser, STFT and synthesis pipeline against the JAX package.

Tolerances: STFT within atol 1e-3 on spectra of magnitude ~10 and the
denoised waveform within atol 1e-5 (float32 FFTs in pocketfft vs XLA);
the whole tiny slice's float waveform within atol 1e-4 and pcm16 within one
step (a truncating cast flips by one where the floats differ in the last
digits); bucket choice, mel lengths and wav lengths exactly equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emojivoice_tpu import config as cfglib
from emojivoice_tpu import text as jax_text
from emojivoice_tpu.inference.pipeline import SynthesisPipeline as JaxPipeline
from emojivoice_tpu.models import MatchaTTS as FlaxMatcha
from emojivoice_tpu.ops import stft as jax_stft
from emojivoice_tpu.utils.masks import intersperse as jax_intersperse
from emojivoice_tpu.vocoder import Denoiser as JaxDenoiser
from emojivoice_tpu.vocoder import HiFiGANGenerator as FlaxHiFiGAN
from emojivoice_tpu_torch.inference import profile_slice
from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
from emojivoice_tpu_torch.io.from_jax import hifigan_state_dict_from_flax, matcha_state_dict_from_flax
from emojivoice_tpu_torch.ops import stft
from emojivoice_tpu_torch.vocoder.denoiser import Denoiser
from tests.test_models import tiny_cfg
from tests.test_vocoder import tiny_hifigan

torch.set_num_threads(2)

N_FFT, HOP = 1024, 256
MEL_BUCKETS = (64, 128, 256)
TEXT_BUCKETS = (64, 128)


def tiny_root():
    model = dataclasses.replace(tiny_cfg(n_spks=4), n_feats=12)
    return cfglib.RootConfig(model=model, vocoder=dataclasses.replace(tiny_hifigan(), num_mels=12))


@pytest.fixture(scope="module")
def pipes():
    """The JAX pipeline at the tiny config and the port's on its weights."""
    root = tiny_root()
    model = FlaxMatcha(cfg=root.model)
    # initialised through the inference path, jitted: the cheapest compile
    init = jax.jit(lambda rng: model.init(
        {"params": rng}, jnp.ones((1, 8), jnp.int32), jnp.array([8]), 16, 1, 1.0, jnp.array([0]), 1.0, None,
        jnp.zeros((1, 16, 12)), method=FlaxMatcha.synthesise))
    params = jax.device_get(init(jax.random.PRNGKey(0)))
    voc_params = jax.device_get(FlaxHiFiGAN(cfg=root.vocoder).init(jax.random.PRNGKey(1), jnp.zeros((1, 8, 12))))
    jp = JaxPipeline(root.model, params, root.vocoder, voc_params, cleaners=("basic_cleaners",),
                     mel_buckets=MEL_BUCKETS, text_buckets=TEXT_BUCKETS)
    pp = SynthesisPipeline.from_state_dicts(
        root.model, matcha_state_dict_from_flax(params, root.model), root.vocoder,
        hifigan_state_dict_from_flax(voc_params, root.vocoder), cleaners=("basic_cleaners",),
        mel_buckets=MEL_BUCKETS, text_buckets=TEXT_BUCKETS, device="cpu")
    return root, jp, params, voc_params, pp


def test_stft_istft_match_jax(rng):
    y = rng.normal(size=(2, HOP * 20)).astype(np.float32) * 0.3
    ref = np.asarray(jax_stft.stft_complex(jnp.asarray(y), N_FFT, HOP, N_FFT, center=True))
    got = stft.stft_complex(torch.from_numpy(y), N_FFT, HOP, N_FFT).numpy()
    assert got.shape == ref.shape == (2, 21, N_FFT // 2 + 1)
    np.testing.assert_allclose(got, ref, atol=1e-3)
    back = stft.istft(torch.from_numpy(got), N_FFT, HOP, N_FFT).numpy()
    ref_back = np.asarray(jax_stft.istft(jnp.asarray(ref), N_FFT, HOP, N_FFT, center=True))
    assert back.shape == ref_back.shape == y.shape
    np.testing.assert_allclose(back, ref_back, atol=1e-5)
    np.testing.assert_allclose(back, y, atol=1e-5)



@pytest.mark.parametrize("frames", [2, 21, 129])
def test_istft_overlap_add_matches_torch_istft(rng, frames, monkeypatch):
    """The port's overlap-add inverse against ``torch.istft`` and the JAX
    ``istft`` on the same spectrum, and its envelope made once per shape."""
    spec = (rng.normal(size=(2, frames, N_FFT // 2 + 1)) + 1j * rng.normal(size=(2, frames, N_FFT // 2 + 1)))
    spec = torch.from_numpy(spec.astype(np.complex64))
    got = stft.istft(spec, N_FFT, HOP, N_FFT)
    ref = torch.istft(spec.transpose(1, 2), N_FFT, HOP, N_FFT, window=torch.hann_window(N_FFT), center=True)
    ref_jax = np.asarray(jax_stft.istft(jnp.asarray(spec.numpy()), N_FFT, HOP, N_FFT, center=True))
    assert got.shape == ref.shape == ref_jax.shape == (2, HOP * (frames - 1))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), ref_jax, atol=1e-5)
    env = stft.istft_envelope(N_FFT, HOP, N_FFT, frames, "cpu")
    assert stft.istft_envelope(N_FFT, HOP, N_FFT, frames, "cpu") is env
    assert env.untyped_storage().nbytes() == env.numel() * 4  # owns its storage: an exported program carries it
    # istft divides by the kept envelope: doubling the kept one halves the result
    monkeypatch.setitem(stft._ENVELOPES, (N_FFT, HOP, N_FFT, frames, torch.device("cpu")), env * 2)
    torch.testing.assert_close(stft.istft(spec, N_FFT, HOP, N_FFT), got / 2, rtol=0, atol=0)


def test_denoiser_and_pipeline_never_call_torch_istft(pipes, monkeypatch):
    """``torch.istft`` checks its window envelope on the host, a wait at the
    end of every denoised dispatch: nothing on the synthesis path calls it."""
    pp = pipes[-1]
    expected = pp.synthesise(["no host wait"], spks=[1], n_timesteps=2, seed=4)[0].wav

    def refuse(*a, **kw):
        raise AssertionError("torch.istft called")

    monkeypatch.setattr(torch, "istft", refuse)
    audio = torch.from_numpy(np.random.default_rng(0).normal(size=(1, HOP * 12)).astype(np.float32)) * 0.1
    assert pp.denoiser(audio, 0.05).shape == audio.shape
    for fused in (False, True):
        res = pp.synthesise(["no host wait"], spks=[1], n_timesteps=2, seed=4, fused=fused,
                            fused_mel_bucket=64 if fused else None)[0]
        assert np.isfinite(res.wav).all() and res.wav.size == res.mel_length * 16
        np.testing.assert_array_equal(res.wav, expected)

def test_rope_tables_reach_the_device_once_per_shape(pipes, monkeypatch):
    """The encoder's RoPE tables are copied to the device once per shape and
    kept: a copy from pageable memory on every call waits for the device."""
    from emojivoice_tpu_torch.ops import rope

    pp = pipes[-1]
    pp.synthesise(["tables made"], spks=[1], n_timesteps=2, seed=0)
    made = []
    real = rope.rope_tables
    monkeypatch.setattr(rope, "rope_tables", lambda *a: made.append(a) or real(*a))
    pp.synthesise(["tables kept"], spks=[1], n_timesteps=2, seed=0)
    assert made == []
    rope._TABLES.clear()
    pp.synthesise(["tables kept"], spks=[1], n_timesteps=2, seed=0)
    assert len(made) == len(set(made)) > 0

def test_denoiser_matches_jax(pipes, rng):
    root, jp, _, voc_params, pp = pipes
    jd = JaxDenoiser(lambda m: jp.vocoder.apply(voc_params, m), mode="zeros", num_mels=12)
    pd = Denoiser(pp.vocoder, num_mels=12)
    np.testing.assert_allclose(pd.bias_spec.numpy(), np.asarray(jd.bias_spec), atol=1e-5)
    audio = rng.normal(size=(2, HOP * 16)).astype(np.float32) * 0.1
    ref = np.asarray(jd(jnp.asarray(audio), 0.05))
    got = pd(torch.from_numpy(audio), 0.05).numpy()
    assert got.shape == ref.shape == audio.shape
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_whole_slice_matches_jax_chain(pipes, rng):
    """text → ids → synthesise with a given z → vocoder → denoiser → pcm16,
    each package's own chain at the tiny config."""
    root, jp, params, voc_params, pp = pipes
    texts, spks, ty, steps, strength = ["hello there", "a longer sentence here"], [1, 3], 128, 2, 0.00025
    x, xl, cleaned, t_bucket = pp.encode_texts(texts)
    ids = [jax_intersperse(jax_text.text_to_sequence(t, ["basic_cleaners"])[0], 0) for t in texts]
    assert t_bucket == 64 and list(xl) == [len(i) for i in ids]
    assert [list(row[:n]) for row, n in zip(x, xl)] == ids
    z = rng.normal(size=(2, ty, 12)).astype(np.float32) * 0.667

    @jax.jit
    def jax_chain(x, xl, spks, z):
        out = jp.model.apply(params, x, xl, ty, steps, 0.667, spks, 1.0, None, z, method=FlaxMatcha.synthesise)
        wav = jp.denoiser(jp.vocoder.apply(voc_params, out["mel"]), strength)
        return out["mel_lengths"], wav, (jnp.clip(wav, -1.0, 1.0) * 32767.0).astype(jnp.int16)

    ml_j, wav_j, pcm_j = jax.device_get(jax_chain(jnp.asarray(x, jnp.int32), jnp.asarray(xl, jnp.int32),
                                                  jnp.asarray(spks, jnp.int32), jnp.asarray(z)))

    out_p = pp.model.synthesise(torch.from_numpy(x), torch.from_numpy(xl), ty, steps, torch.from_numpy(z),
                                torch.tensor(spks))
    wav_p = pp.denoiser(pp.vocoder(out_p["mel"]), strength)
    pcm_p = (torch.clamp(wav_p, -1.0, 1.0) * 32767.0).to(torch.int16).numpy()

    np.testing.assert_array_equal(out_p["mel_lengths"].numpy(), ml_j)
    assert wav_p.shape == wav_j.shape == (2, ty * 16)
    np.testing.assert_allclose(wav_p.numpy(), wav_j, atol=1e-4)
    assert np.abs(pcm_p.astype(np.int32) - pcm_j.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("fused", [False, True])
def test_pipeline_lengths_match_jax(pipes, fused):
    """Same texts, same weights: the mel bucket, mel lengths and wav lengths
    of the port's pipeline equal the JAX pipeline's (noise differs)."""
    _, jp, _, _, pp = pipes
    texts, spks = ["hi", "the port keeps the buckets"], [0, 2]
    kw = dict(spks=spks, n_timesteps=2, seed=0, fused=fused, fused_mel_bucket=128 if fused else None)
    ref = jp.synthesise(texts, **kw)
    got = pp.synthesise(texts, pcm16=True, **kw)
    assert pp.encode_texts(texts)[3] == jp.encode_texts(texts)[3]
    for lang in ("fr", "ja"):
        x_p, xl_p, cleaned_p, _ = pp.encode_texts(["Ça va? こんにちは 3"], language=lang)
        x_j, xl_j, cleaned_j, _ = jp.encode_texts(["Ça va? こんにちは 3"], language=lang)
        assert cleaned_p == cleaned_j and np.array_equal(x_p, x_j) and np.array_equal(xl_p, xl_j)
    with pytest.raises(KeyError):
        pp.encode_texts(["hi"], language="xx")
    for r, g in zip(ref, got):
        assert g.mel_length == r.mel_length
        assert g.wav.shape == r.wav.shape == (g.mel_length * 16,)
        assert g.mel.shape == r.mel.shape
        assert np.isfinite(g.wav).all() and np.abs(g.wav).max() <= 1.0
        assert g.rtf > 0 and g.rtf_w > 0
        assert set(g.stage_ms) == {"encoder", "decoder", "vocoder", "denoiser"}


def test_per_row_seed_contract(pipes):
    """A row's noise depends only on its own seed: a row inside a batch
    draws the same noise as the batch-1 call with that seed."""
    pp = pipes[-1]
    text = "the same text in every row"
    batched = pp.synthesise([text] * 3, spks=[2, 2, 2], n_timesteps=2, seed=[7, 8, 7])
    direct7 = pp.synthesise([text], spks=[2], n_timesteps=2, seed=7)[0]
    direct8 = pp.synthesise([text], spks=[2], n_timesteps=2, seed=8)[0]
    np.testing.assert_allclose(batched[0].wav, direct7.wav, atol=1e-5)
    np.testing.assert_allclose(batched[1].wav, direct8.wav, atol=1e-5)
    np.testing.assert_array_equal(batched[2].wav, batched[0].wav)
    assert float(np.abs(batched[0].wav - batched[1].wav).max()) > 1e-3
    again = pp.synthesise([text], spks=[2], n_timesteps=2, seed=7)[0]
    np.testing.assert_array_equal(again.wav, direct7.wav)
    with pytest.raises(ValueError, match="seeds"):
        pp.synthesise(["a", "b"], n_timesteps=2, seed=[1, 2, 3])


def test_warmup_and_output_switches(pipes):
    pp = pipes[-1]
    pp.warmup(n_timesteps=2, batch=2, pcm16=True)
    mel_only = pp.synthesise(["just the mel"], spks=[1], n_timesteps=2, seed=3, vocode=False)[0]
    assert mel_only.wav.size == 0 and mel_only.mel.shape == (mel_only.mel_length, 12)
    assert np.isnan(mel_only.rtf_w) and set(mel_only.stage_ms) == {"encoder", "decoder"}
    wav_only = pp.synthesise(["just the mel"], spks=[1], n_timesteps=2, seed=3, keep_mel=False,
                             denoiser_strength=0.0)[0]
    assert wav_only.mel.size == 0 and wav_only.wav.shape == (mel_only.mel_length * 16,)
    assert "denoiser" not in wav_only.stage_ms


def test_profile_slice_measures_a_request(pipes):
    """The profiling script's two measurements on the tiny pipeline; on the
    CPU there is no device activity, so the busy share is not measured."""
    pp = pipes[-1]
    timed = profile_slice.time_request(pp, ["hi there"], [1], 2, n_timesteps=2, pcm16=True)
    assert timed["wall_ms"] > 0 and len(timed["wall_ms_all"]) == 2 and timed["rtf_w"] > 0
    assert set(timed["stage_ms"]) == {"encoder", "decoder", "vocoder", "denoiser"}
    prof = profile_slice.profile_request(pp, ["hi there"], [1], n_timesteps=2)
    assert prof["profiled_wall_ms"] > 0 and prof["device_activities"] == 0 and prof["busy"] is None
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            profile_slice.main([])
