"""The port's streaming vocoder, playback strategy and long-form synthesis
against the JAX package (``inference/streaming.py``, ``inference/longform.py``).

Host-side functions (``split_text``, ``_prepare_segments``,
``estimate_audio_seconds``, ``choose_strategy``) must answer exactly as the
JAX package's on a list of texts and on generated ones.  One seeded mel goes
through the JAX ``StreamingVocoder`` (plain flax forward) and the port's on
the bridged weights: same chunk lengths, samples within atol 2e-4 (the bound
``tests/test_torch_mrf_hifigan.py`` holds the generator to).  The port's
streamed audio against its own monolithic call: within atol 1e-6 (the JAX
contract) when the overlap covers the receptive field, off by more than 1e-3
at overlap 0.  The receptive field is computed here from the config (an upper
bound: 9 frames for the tiny generator, whose streamed audio is already exact
at the default 8); at a
narrow HiFi-GAN-v1-shaped config (v1's kernels, dilations and upsample rates)
it is 14 mel frames a side, so the default overlap of 8 leaks there.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from emojivoice_tpu.inference import longform as jax_longform
from emojivoice_tpu.inference import streaming as jax_streaming
from emojivoice_tpu.vocoder import HiFiGANGenerator as FlaxHiFiGAN
from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.apps.emoji import EMOJI_MAPPING
from emojivoice_tpu_torch.inference import longform, streaming
from emojivoice_tpu_torch.inference.streaming import StreamingVocoder, auto_stream, stream_synthesise
from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator
from tests.test_torch_serving import bridged_pipeline, flax_tiny_params

torch.set_num_threads(2)

TEXTS = [
    "",
    "Hello.",
    "That sounds like a wonderful plan!",
    "First sentence here. And then a second one follows. And a third!",
    "One… two… three? Four! Five.",
    "word " * 40,
    "a" * 450,
    "No punctuation at all just a long run of words that goes on, and on, with commas, but no full stop " * 3,
    "Wow 😎 that is great! I am so sorry 😭. Plain ending",
    "  leading and trailing space.   ",
    "Ça va? こんにちは 3. ¿Qué tal?",
]


def receptive_field_frames(cfg) -> int:
    """Mel frames of context a side that one output sample of the HiFi-GAN
    generator depends on: each layer's reach in samples over the samples per
    mel frame at its rate, summed (conv_pre and conv_post 7 taps; a
    transposed conv k/(2u) input samples; an MRF stage its widest res-block,
    (k−1)/2 · (Σd + n_d))."""
    reach, rate = 3.0, 1
    for u, k in zip(cfg.upsample_rates, cfg.upsample_kernel_sizes):
        reach += k / (2 * u) / rate
        rate *= u
        reach += max((rk - 1) // 2 * (sum(d) + len(d)) for rk, d in
                     zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)) / rate
    return math.ceil(reach + 3.0 / rate)


@pytest.fixture(scope="module")
def pipe():
    return bridged_pipeline(mel_buckets=(64, 128, 256), text_buckets=(64, 128))


# ---------------------------------------------------------------------------
# host-side functions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_chars", [30, 120, 200])
def test_split_text_and_segments_equal_jax(max_chars):
    for text in TEXTS:
        assert longform.split_text(text, max_chars) == jax_longform.split_text(text, max_chars), text
        for emoji_voices in (False, True):
            assert longform._prepare_segments(text, 7, emoji_voices, max_chars) == \
                jax_longform._prepare_segments(text, 7, emoji_voices, max_chars), text
    assert longform.split_text("One. Two! Three?", 200) == ["One. Two! Three?"]
    assert longform._prepare_segments("Yes 😎. Oh no 😭!", 3, True, 8) == \
        [(EMOJI_MAPPING["😎"], "Yes ."), (EMOJI_MAPPING["😭"], "Oh no !")]


@pytest.mark.parametrize("length_scale", [1.0, 2.0])
def test_strategy_and_estimate_equal_jax(length_scale):
    assert streaming.STREAM_MIN_AUDIO_S == jax_streaming.STREAM_MIN_AUDIO_S
    assert streaming.CHARS_PER_SECOND == jax_streaming.CHARS_PER_SECOND
    for text in TEXTS:
        assert streaming.estimate_audio_seconds(text, length_scale) == \
            jax_streaming.estimate_audio_seconds(text, length_scale)
        for segment_chars in (30, 120, 400):
            assert streaming.choose_strategy(text, segment_chars, length_scale) == \
                jax_streaming.choose_strategy(text, segment_chars, length_scale), text
    assert streaming.choose_strategy("That sounds like a wonderful plan!")[0] == "full"
    assert streaming.choose_strategy("word " * 40, 400)[0] == "stream"
    assert streaming.choose_strategy("First one here. A second follows.", 20)[0] == "pipelined"
    assert streaming.choose_strategy("word " * 20, 400, length_scale)[0] == ("full" if length_scale == 1.0 else "stream")


@settings(max_examples=60, deadline=None, database=None)
@given(text=st.text(alphabet=st.sampled_from(list("abc ,.!?…😎😭\n")), max_size=300),
       max_chars=st.integers(min_value=8, max_value=250), length_scale=st.floats(0.5, 3.0))
def test_host_side_functions_equal_jax_on_generated_text(text, max_chars, length_scale):
    ours = longform.split_text(text, max_chars)
    assert ours == jax_longform.split_text(text, max_chars)
    assert all(0 < len(s) <= max_chars for s in ours)
    assert longform._prepare_segments(text, 1, True, max_chars) == jax_longform._prepare_segments(text, 1, True, max_chars)
    assert streaming.choose_strategy(text, max_chars, length_scale) == \
        jax_streaming.choose_strategy(text, max_chars, length_scale)


# ---------------------------------------------------------------------------
# streaming vocoder
# ---------------------------------------------------------------------------

def test_streaming_vocoder_matches_jax_chunk_for_chunk(pipe, rng):
    """One seeded mel through the JAX StreamingVocoder (plain flax forward)
    and the port's on the bridged weights."""
    jax_root, _, voc_params = flax_tiny_params()
    mel = rng.normal(size=(128, 12)).astype(np.float32) * 2 - 6  # bucket-sized
    ref = list(jax_streaming.StreamingVocoder(FlaxHiFiGAN(cfg=jax_root.vocoder), voc_params, chunk_frames=32,
                                              overlap=8).stream(mel, mel_length=100))
    got = list(StreamingVocoder(pipe.vocoder, chunk_frames=32, overlap=8).stream(mel, mel_length=100))
    assert [len(c) for c in got] == [len(c) for c in ref] == [512, 512, 512, 64]
    assert all(c.dtype == np.float32 for c in got)
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(ref), atol=2e-4)
    # a mel that is no multiple of the chunk is zero-padded, as in the JAX package
    ref = list(jax_streaming.StreamingVocoder(FlaxHiFiGAN(cfg=jax_root.vocoder), voc_params, chunk_frames=32,
                                              overlap=8).stream(mel[:70]))
    got = list(StreamingVocoder(pipe.vocoder, chunk_frames=32, overlap=8).stream(mel[:70]))
    assert [len(c) for c in got] == [len(c) for c in ref] == [512, 512, 96]
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(ref), atol=2e-4)


def test_streaming_matches_monolithic(pipe, rng):
    """Chunked vocoding equals the monolithic call when the overlap covers
    the receptive field (boundary windows share the conv zero padding), through
    the plain forward and through the pipeline's ``_vocode``."""
    overlap = receptive_field_frames(pipe.vocoder_cfg)
    assert overlap == 9
    mel = rng.normal(size=(128, 12)).astype(np.float32) * 2 - 6
    mono = pipe._vocode(torch.from_numpy(mel)[None])[0].numpy()
    for vocode_fn in (None, pipe._vocode):
        sv = StreamingVocoder(pipe.vocoder, chunk_frames=32, overlap=overlap, vocode_fn=vocode_fn)
        streamed = np.concatenate(list(sv.stream(torch.from_numpy(mel), mel_length=100)))
        assert streamed.shape[0] == 100 * sv.ups
        np.testing.assert_allclose(streamed, mono[: len(streamed)], atol=1e-6)
    # a single-chunk utterance is one whole call
    one = list(StreamingVocoder(pipe.vocoder, chunk_frames=128, overlap=8).stream(mel, mel_length=100))
    assert len(one) == 1
    np.testing.assert_array_equal(one[0], mono[: 100 * 16])


def test_streaming_insufficient_overlap_detected(pipe, rng):
    mel = rng.normal(size=(128, 12)).astype(np.float32) * 2 - 6
    sv = StreamingVocoder(pipe.vocoder, chunk_frames=32, overlap=0)
    streamed = np.concatenate(list(sv.stream(mel, mel_length=128)))
    mono = pipe.vocoder(torch.from_numpy(mel)[None])[0].numpy()
    assert np.abs(streamed - mono).max() > 1e-3


def test_default_overlap_does_not_cover_hifigan_v1():
    """HiFi-GAN v1 reaches 14 mel frames a side: at a narrow generator with
    v1's kernels, dilations and upsample rates, overlap 8 leaks into the
    interior and an overlap of the receptive field does not."""
    v1 = cfglib.HiFiGANConfig()
    assert receptive_field_frames(v1) == 14
    narrow = cfglib.HiFiGANConfig(upsample_initial_channel=32, num_mels=12)
    assert receptive_field_frames(narrow) == 14
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        gen = HiFiGANGenerator(narrow).eval()
        for p in gen.parameters():  # weights large enough for a leak to show in f32
            p.data.mul_(8.0)
    mel = torch.from_numpy(np.random.default_rng(3).normal(size=(128, 12)).astype(np.float32))
    mono = gen(mel[None])[0].numpy()
    err = {}
    for ov in (8, 14):
        streamed = np.concatenate(list(StreamingVocoder(gen, chunk_frames=32, overlap=ov).stream(mel)))
        err[ov] = float(np.abs(streamed - mono).max())
    assert err[14] <= 1e-6 < err[8], err


# ---------------------------------------------------------------------------
# stream_synthesise, auto_stream, long-form
# ---------------------------------------------------------------------------

def test_stream_synthesise_generator(pipe):
    pipe._streaming_vocoder = None
    chunks = list(stream_synthesise(pipe, "streaming hello world", spk=1, n_timesteps=2, seed=0,
                                    chunk_frames=16, overlap=8))
    total = sum(len(c) for c in chunks)
    assert len(chunks) >= 1 and total > 0 and total % 16 == 0  # 16 samples a mel frame
    assert pipe._streaming_vocoder is not None and pipe._streaming_vocoder.overlap == 8
    # the chunks are the pipeline's own vocoding of the same mel, zero-padded to whole chunks
    mel_only = pipe.synthesise(["streaming hello world"], spks=[1], n_timesteps=2, seed=0, vocode=False)[0]
    padded = np.pad(mel_only.mel, ((0, -mel_only.mel_length % 16), (0, 0)))
    mono = pipe._vocode(torch.from_numpy(padded)[None])[0].numpy()
    assert total == mel_only.mel_length * 16
    np.testing.assert_allclose(np.concatenate(chunks), mono[:total], atol=1e-6)


def test_choose_strategy_and_auto_stream(pipe, monkeypatch):
    wav = np.concatenate(list(auto_stream(pipe, "hello there", spk=1, n_timesteps=2, seed=3)))
    ref = pipe.synthesise(["hello there"], spks=[1], n_timesteps=2, seed=3)[0].wav
    np.testing.assert_array_equal(wav, ref)  # auto picks one full call
    wav_s = np.concatenate(list(auto_stream(pipe, "hello there", spk=1, n_timesteps=2, seed=3, strategy="stream")))
    assert wav_s.size == ref.size  # the chunked path, undenoised
    text = "First sentence here. And then a second one follows. And a third!"
    piped = list(auto_stream(pipe, text, spk=1, segment_chars=30, n_timesteps=2, seed=3))
    assert len(piped) == len(jax_streaming.choose_strategy(text, 30)[1]) == 3

    class NoVocode:  # a backend without a mel-only call: auto degrades, a forced stream is the caller's fault
        synthesise = pipe.synthesise

    monkeypatch.setattr(streaming, "STREAM_MIN_AUDIO_S", 0.1)  # so that a text the tiny buckets hold picks "stream"
    assert streaming.choose_strategy("hello there")[0] == "stream"
    np.testing.assert_array_equal(np.concatenate(list(auto_stream(NoVocode(), "hello there", spk=1, n_timesteps=2, seed=3))), ref)
    streamed = np.concatenate(list(auto_stream(pipe, "hello there", spk=1, n_timesteps=2, seed=3)))
    np.testing.assert_array_equal(streamed, wav_s)  # the live pipeline does stream it
    with pytest.raises(ValueError, match="live pipeline"):
        next(auto_stream(NoVocode(), "hi", strategy="stream"))


def test_longform_concat_and_emoji_voices(pipe):
    text = "Hello there. This is a long text! Does it work? Yes it does."
    segs = jax_longform._prepare_segments(text, 1, False, 30)
    chunks = list(longform.stream_longform(pipe, text, spk=1, max_chars=30, n_timesteps=2, seed=5))
    assert len(chunks) == len(segs) == 3
    gap = int(0.15 * 22050)
    for (seg_spk, seg), chunk, last in zip(segs, chunks, (False, False, True)):
        direct = pipe.synthesise([seg], spks=[seg_spk], n_timesteps=2, seed=5)[0].wav
        np.testing.assert_array_equal(chunk[: len(direct)], direct)  # dispatch-ahead changes no sample
        assert len(chunk) == len(direct) + (0 if last else gap) and not chunk[len(direct):].any()
    wav = longform.synthesise_longform(pipe, text, spk=1, max_chars=30, n_timesteps=2, seed=5)
    np.testing.assert_array_equal(wav, np.concatenate(chunks))
    assert longform.synthesise_longform(pipe, "", n_timesteps=2).shape == (0,)
    # per-segment emoji cues switch the voice
    a = longform.synthesise_longform(pipe, "Great 😎. Great.", spk=0, emoji_voices=True, max_chars=10,
                                     n_timesteps=2, seed=1)
    b = longform.synthesise_longform(pipe, "Great 😎. Great.", spk=0, emoji_voices=False, max_chars=10,
                                     n_timesteps=2, seed=1)
    assert a.size > 0 and b.size > 0 and (a.size != b.size or not np.allclose(a, b))


def test_play_longform_speaks_each_segment(pipe):
    class Sink:
        def __init__(self):
            self.played = []

        def play(self, wav, sr):
            self.played.append((len(wav), sr))

    sink, first = Sink(), []
    n = longform.play_longform(pipe, "One sentence. Two sentences.", sink, spk=1, max_chars=15,
                               on_first_audio=lambda: first.append(len(sink.played)), n_timesteps=2, seed=0)
    assert n == 2 == len(sink.played) and first == [0]
    assert all(sr == 22050 and length > 0 for length, sr in sink.played)
