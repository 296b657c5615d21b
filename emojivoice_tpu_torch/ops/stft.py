"""STFT / iSTFT in the vocoder denoiser's convention (PyTorch port of the
denoiser half of ``emojivoice_tpu.ops.stft``): n_fft 1024, hop 256,
``center=True`` with reflect padding, periodic Hann window.

Spectrograms are channels-last ``(B, T_frames, F)`` like the JAX package's;
waveforms are ``(B, L)``.
"""

from __future__ import annotations

import torch


def _window(win_length: int, device) -> torch.Tensor:
    return torch.hann_window(win_length, periodic=True, dtype=torch.float32, device=device)


def stft_complex(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """(B, L) → complex (B, T_frames, F), T_frames = 1 + L // hop."""
    spec = torch.stft(y, n_fft, hop_length, win_length, window=_window(win_length, y.device), center=True,
                      pad_mode="reflect", normalized=False, onesided=True, return_complex=True)
    return spec.transpose(1, 2)


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """complex (B, T_frames, F) → (B, hop · (T_frames − 1))."""
    return torch.istft(spec.transpose(1, 2), n_fft, hop_length, win_length,
                       window=_window(win_length, spec.device), center=True, normalized=False, onesided=True)
