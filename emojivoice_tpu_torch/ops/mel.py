"""Log-mel spectrogram extraction (PyTorch port of ``emojivoice_tpu.ops.mel``).

The reference chain ``torch.stft + librosa.filters.mel + log-clamp``:
reflect-pad ``(n_fft − hop)/2`` on both sides, ``center=False`` STFT,
magnitude ``sqrt(power + 1e-9)``, Slaney-normalized mel filterbank,
``log(clamp(x, 1e-5))``.

The filterbank is computed in numpy from the Slaney mel scale directly
(librosa is not a dependency); values agree with ``librosa.filters.mel``
defaults (htk=False, norm='slaney') to float32 precision.  The data pipeline
(``data/audio_np.py``) uses the same filterbank on the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from emojivoice_tpu_torch.ops.stft import stft_magnitude


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    mels = np.where(above, min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    freqs = np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=8)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Triangular Slaney-normalized filterbank, shape (F, n_mels) = (1+n_fft/2, n_mels).

    Transposed relative to librosa's (n_mels, F) because our spectrograms are
    channels-last: mel = |STFT| @ filterbank is one matrix product.
    """
    fftfreqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel(np.array(fmin)), _hz_to_mel(np.array(fmax)), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)  # (n_mels + 2,)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]  # (n_mels+2, F)

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))  # (n_mels, F)

    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return np.ascontiguousarray(weights.T.astype(np.float32))  # (F, n_mels)


@functools.lru_cache(maxsize=8)
def _filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float, device: torch.device) -> torch.Tensor:
    """The filterbank on `device`, made once: a captured step
    (``training/vocoder_graphs.py``) can copy nothing up from the host."""
    return torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, fmin, fmax)).to(device)


def mel_spectrogram(y: torch.Tensor, n_fft: int = 1024, num_mels: int = 80, sampling_rate: int = 22050,
                    hop_size: int = 256, win_size: int = 1024, fmin: float = 0.0,
                    fmax: float = 8000.0) -> torch.Tensor:
    """(B, L) waveform in [-1, 1] → (B, T_frames, n_mels) log-mel.

    For L a multiple of hop_size, T_frames = L // hop_size.
    """
    pad = int((n_fft - hop_size) / 2)
    y = F.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    mag = stft_magnitude(y, n_fft, hop_size, win_size, eps=1e-9)
    fb = _filterbank(sampling_rate, n_fft, num_mels, fmin, fmax, y.device)
    return torch.log(torch.clamp(torch.matmul(mag, fb), min=1e-5))
