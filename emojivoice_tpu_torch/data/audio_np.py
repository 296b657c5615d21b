"""Host-side (numpy) audio utilities for the data pipeline (the port's copy
of ``emojivoice_tpu.data.audio_np``).

Same numerics as the tensor ops (``ops/stft.py``, ``ops/mel.py``), in numpy so
that loading data never touches the accelerator.

Reference equivalents: matcha/utils/audio.py:45-82 (mel), torchaudio load +
22050 Hz requirement (README.md:156 — fine-tune data must be 22.05 kHz;
``resample_poly_np`` provides the resample the reference leaves to the
user).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from emojivoice_tpu_torch.ops.mel import mel_filterbank
from emojivoice_tpu_torch.ops.stft import hann_window_np as hann_window


def wav_info(path: str) -> Tuple[int, int]:
    """(num_sample_frames, sample_rate) from the WAV header ONLY — no
    decode.  RIFF chunk walk handles PCM and IEEE-float files (the stdlib
    `wave` module rejects float WAVs)."""
    import struct

    with open(path, "rb") as f:
        riff = f.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"not a RIFF/WAVE file: {path}")
        channels = bits = rate = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size + (size & 1))  # chunks are word-aligned
                _, channels, rate = struct.unpack("<HHI", fmt[:8])
                bits = struct.unpack("<H", fmt[14:16])[0]
            elif cid == b"data":
                if channels is None or not bits:
                    break
                return size // (channels * (bits // 8)), int(rate)
            else:
                f.seek(size + (size & 1), 1)  # chunks are word-aligned
    raise ValueError(f"no fmt/data chunks found: {path}")


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a wav file → (float32 in [-1, 1], sample_rate)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:
        data = data.mean(axis=1)
    return data, int(sr)


def resample_poly_np(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Polyphase resample (e.g. 44.1 kHz recordings → 22.05 kHz)."""
    if sr_in == sr_out:
        return x.astype(np.float32)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    return resample_poly(x, sr_out // g, sr_in // g).astype(np.float32)


def mel_spectrogram_np(
    y: np.ndarray,
    n_fft: int = 1024,
    num_mels: int = 80,
    sampling_rate: int = 22050,
    hop_size: int = 256,
    win_size: int = 1024,
    fmin: float = 0.0,
    fmax: float = 8000.0,
) -> np.ndarray:
    """(L,) waveform → (T_frames, n_mels) log-mel; numpy twin of
    ops.mel.mel_spectrogram (center=False after (n_fft-hop)/2 reflect pad)."""
    pad = int((n_fft - hop_size) / 2)
    y = np.pad(y, (pad, pad), mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop_size
    idx = np.arange(n_frames)[:, None] * hop_size + np.arange(n_fft)[None, :]
    frames = y[idx] * hann_window(win_size)
    spec = np.fft.rfft(frames, n=n_fft, axis=-1)
    mag = np.sqrt(spec.real**2 + spec.imag**2 + 1e-9)
    fb = mel_filterbank(sampling_rate, n_fft, num_mels, fmin, fmax)
    mel = mag.astype(np.float32) @ fb
    return np.log(np.clip(mel, 1e-5, None)).astype(np.float32)
