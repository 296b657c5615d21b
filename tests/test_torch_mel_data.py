"""The port's mel extraction and data pipeline against the JAX package's.

Tolerances: the filterbank, the host-side (numpy) mel and the collated
batches are copies of the same numpy code and must be equal; the tensor
``mel_spectrogram`` goes through ``torch.stft`` where the JAX one frames and
calls ``rfft``, so log-mels agree within atol 1e-4 (f32 FFT rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emojivoice_tpu import config as jax_cfglib
from emojivoice_tpu.data import audio_np as jax_audio
from emojivoice_tpu.data import dataset as jax_data
from emojivoice_tpu.ops import mel as jax_mel
from emojivoice_tpu.training import scratch_proof
from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.data import audio_np, dataset
from emojivoice_tpu_torch.ops import mel
from emojivoice_tpu_torch.ops.stft import hann_window_np
from emojivoice_tpu_torch.training import synthetic

torch.set_num_threads(2)


def _wave(seed, n):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 22050.0
    return (0.4 * np.sin(2 * np.pi * 220.0 * t) + 0.2 * np.sin(2 * np.pi * 1730.0 * t)
            + 0.05 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("args", [(22050, 1024, 80, 0.0, 8000.0), (16000, 512, 40, 50.0, 7600.0)])
def test_mel_filterbank_equal(args):
    np.testing.assert_array_equal(mel.mel_filterbank(*args), jax_mel.mel_filterbank(*args))
    from emojivoice_tpu.ops.stft import hann_window

    np.testing.assert_array_equal(hann_window_np(1024), hann_window(1024))
    np.testing.assert_allclose(hann_window_np(1024), torch.hann_window(1024).numpy(), atol=2e-7)


@pytest.mark.parametrize("n", [256 * 40, 256 * 13 + 100])
def test_mel_spectrogram_matches_jax(n):
    y = np.stack([_wave(0, n), _wave(1, n)])
    ours = mel.mel_spectrogram(torch.from_numpy(y)).numpy()
    theirs = np.asarray(jax_mel.mel_spectrogram(jnp.asarray(y)))
    assert ours.shape == theirs.shape == (2, n // 256, 80)
    np.testing.assert_allclose(ours, theirs, atol=1e-4, rtol=0)


def test_host_mel_equals_jax_package_and_agrees_with_the_tensor_mel():
    y = _wave(2, 256 * 30)
    ours = audio_np.mel_spectrogram_np(y)
    np.testing.assert_array_equal(ours, jax_audio.mel_spectrogram_np(y))
    np.testing.assert_allclose(ours, mel.mel_spectrogram(torch.from_numpy(y)[None])[0].numpy(), atol=1e-4, rtol=0)


def test_synthetic_corpus_equals_jax_package(tmp_path):
    ours = synthetic.make_alignable_dataset(tmp_path / "a", [0, 1, 2], n_utts=4, seed=3, long_texts=True)
    theirs = scratch_proof.make_alignable_dataset(tmp_path / "b", [0, 1, 2], n_utts=4, seed=3, long_texts=True)
    assert ours[2] == theirs[2]
    for i in range(4):
        a, sr = audio_np.load_wav(str(tmp_path / "a" / "wavs" / f"u{i}.wav"))
        b, _ = jax_audio.load_wav(str(tmp_path / "b" / "wavs" / f"u{i}.wav"))
        assert sr == 22050
        np.testing.assert_array_equal(a, b)
    path = str(tmp_path / "a" / "wavs" / "u3.wav")
    assert audio_np.wav_info(path) == jax_audio.wav_info(path) == (len(a), 22050)


@pytest.mark.parametrize("shuffle,min_mel", [(True, None), (False, 256)])
def test_collated_batches_equal_jax_bucket_batcher(tmp_path, shuffle, min_mel):
    train, _, _ = synthetic.make_alignable_dataset(tmp_path, [0, 1, 2, 3], n_utts=5, seed=1)
    ours_ds = dataset.TextMelDataset(str(train), cfglib.get_preset("tiny").data, cache_items=True)
    theirs_ds = jax_data.TextMelDataset(str(train), jax_cfglib.get_preset("tiny").data)
    assert ours_ds.items == theirs_ds.items
    ours = dataset.BucketBatcher(ours_ds, 2, shuffle=shuffle, seed=7, min_mel_bucket=min_mel)
    theirs = jax_data.BucketBatcher(theirs_ds, 2, shuffle=shuffle, seed=7, min_mel_bucket=min_mel)
    for _ in range(2):  # two epochs: the reshuffle follows too
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            assert sorted(x) == sorted(y)
            for k in x:
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    # the one-shot fast-forward that resume uses
    ours.skip_next = theirs.skip_next = 2
    a, b = list(dataset.Prefetcher(ours)), list(theirs)
    assert len(a) == len(b) == 1
    np.testing.assert_array_equal(a[0]["y"], b[0]["y"])


def test_dataset_rejects_out_of_range_speaker(tmp_path):
    train, _, _ = synthetic.make_alignable_dataset(tmp_path, [0, 9], n_utts=2, seed=0)
    with pytest.raises(ValueError, match="speaker id 9"):
        dataset.TextMelDataset(str(train), cfglib.get_preset("tiny").data)
