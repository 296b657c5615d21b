"""STFT / iSTFT (PyTorch port of ``emojivoice_tpu.ops.stft``) in the two
conventions the system uses, both with a periodic Hann window: the vocoder
denoiser's (``center=True`` with reflect padding) and mel extraction's
(``center=False`` on a signal the caller padded, magnitude
``sqrt(power + eps)``).

Spectrograms are channels-last ``(B, T_frames, F)`` like the JAX package's;
waveforms are ``(B, L)``.
"""

from __future__ import annotations

import numpy as np
import torch


def _window(win_length: int, device) -> torch.Tensor:
    return torch.hann_window(win_length, periodic=True, dtype=torch.float32, device=device)


def hann_window_np(win_length: int) -> np.ndarray:
    """Periodic Hann window in numpy (``torch.hann_window(win_length)`` to f32 rounding)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def stft_complex(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """(B, L) → complex (B, T_frames, F), T_frames = 1 + L // hop."""
    spec = torch.stft(y, n_fft, hop_length, win_length, window=_window(win_length, y.device), center=True,
                      pad_mode="reflect", normalized=False, onesided=True, return_complex=True)
    return spec.transpose(1, 2)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """complex (B, T_frames, F) → (B, hop · (T_frames − 1))."""
    return torch.istft(spec.transpose(1, 2), n_fft, hop_length, win_length,
                       window=_window(win_length, spec.device), center=True, normalized=False, onesided=True)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int, eps: float = 1e-9) -> torch.Tensor:
    """Mel extraction's convention: (B, L) already padded → magnitude
    ``sqrt(re² + im² + eps)`` (B, T_frames, F), T_frames = 1 + (L − n_fft) // hop."""
    spec = torch.stft(y, n_fft, hop_length, win_length, window=_window(win_length, y.device), center=False,
                      normalized=False, onesided=True, return_complex=True)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + eps).transpose(1, 2)
