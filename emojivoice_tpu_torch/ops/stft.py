"""STFT / iSTFT (PyTorch port of ``emojivoice_tpu.ops.stft``) in the two
conventions the system uses, both with a periodic Hann window: the vocoder
denoiser's (``center=True`` with reflect padding) and mel extraction's
(``center=False`` on a signal the caller padded, magnitude
``sqrt(power + eps)``).

Spectrograms are channels-last ``(B, T_frames, F)`` like the JAX package's;
waveforms are ``(B, L)``.

``istft`` is an overlap-add of the port's own (irfft per frame, times the
window, ``F.fold``, divided by the window envelope), not ``torch.istft``:
that call checks its envelope for zeros on the host, which waits for the
device at the end of every denoised dispatch and cannot live in an exported
program.  The envelope depends only on (n_fft, hop, frames), so it is made
once per key and device and kept.  ``torch.export`` reads the kept envelope,
which becomes a constant on the device of the program (an exporter runs the
model once first), as ``ops.rope``'s tables do; a trace never adds to them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# (n_fft, hop, win_length, frames, device) → the trimmed window envelope on that device
_ENVELOPES: dict = {}


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


def _overlap_add(frames: torch.Tensor, hop_length: int) -> torch.Tensor:
    """(B, T_frames, n) → (B, n + hop · (T_frames − 1)): frame t added in at t · hop."""
    b, t, n = frames.shape
    out = F.fold(frames.transpose(1, 2), output_size=(1, n + hop_length * (t - 1)), kernel_size=(1, n),
                 stride=(1, hop_length))
    return out.reshape(b, -1)


def _padded_window(n_fft: int, win_length: int, device) -> torch.Tensor:
    w = _window(win_length, device)
    left = (n_fft - win_length) // 2
    return F.pad(w, (left, n_fft - win_length - left))


def istft_envelope(n_fft: int, hop_length: int, win_length: int, frames: int, device) -> torch.Tensor:
    """The overlap-added squared window of `frames` frames, trimmed as
    ``istft`` trims its output: (hop · (frames − 1),) f32 on `device`.  Made
    once per key; raises if it has a zero, where the inverse is undefined."""
    key = (n_fft, hop_length, win_length, frames, torch.device(device))
    env = _ENVELOPES.get(key)
    if env is None:
        w = _padded_window(n_fft, win_length, "cpu")
        full = _overlap_add((w * w).expand(1, frames, n_fft), hop_length)[0]
        env = full[n_fft // 2: n_fft // 2 + hop_length * (frames - 1)].clone()  # owns its storage
        if not bool((env.abs() > 1e-11).all()):
            raise ValueError(f"istft: the window envelope of n_fft={n_fft}, hop={hop_length}, "
                             f"win_length={win_length} has a zero")
        env = env.to(device)
        if not torch.compiler.is_compiling():
            env = _ENVELOPES.setdefault(key, env)
    return env


def istft(spec: torch.Tensor, n_fft: int, hop_length: int, win_length: int) -> torch.Tensor:
    """complex (B, T_frames, F) → (B, hop · (T_frames − 1)), ``center=True``."""
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1) * _padded_window(n_fft, win_length, spec.device)
    t = spec.shape[1]
    y = _overlap_add(frames, hop_length)[:, n_fft // 2: n_fft // 2 + hop_length * (t - 1)]
    return y / istft_envelope(n_fft, hop_length, win_length, t, spec.device)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int, eps: float = 1e-9) -> torch.Tensor:
    """Mel extraction's convention: (B, L) already padded → magnitude
    ``sqrt(re² + im² + eps)`` (B, T_frames, F), T_frames = 1 + (L − n_fft) // hop."""
    spec = torch.stft(y, n_fft, hop_length, win_length, window=_window(win_length, y.device), center=False,
                      normalized=False, onesided=True, return_complex=True)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + eps).transpose(1, 2)
