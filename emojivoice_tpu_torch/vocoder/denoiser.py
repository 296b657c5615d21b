"""WaveGlow-style spectral denoiser (PyTorch port of
``emojivoice_tpu.vocoder.denoiser``).

At construction the vocoder is probed with an all-zero mel (1, 88, n_mels)
and the magnitude of its frame 0 is kept as the bias spectrum.  A call
subtracts ``bias · strength`` from every magnitude frame, clamps at zero and
resynthesises with the original phase through the complex ratio
``spec · max(mag − bias·s, 0) / max(mag, 1e-12)``.  STFT: n_fft 1024,
hop 256, window 1024 (the reference denoiser's own convention); the inverse
is ``ops.stft.istft``'s overlap-add, which reads nothing on the host.
"""

from __future__ import annotations

import torch

from emojivoice_tpu_torch.ops.stft import istft, stft_complex

N_FFT = 1024
HOP = N_FFT // 4
WIN = 1024


def denoise(audio: torch.Tensor, bias_spec: torch.Tensor, strength: float) -> torch.Tensor:
    """audio (B, L) → denoised audio (B, hop · (n_frames − 1)) with the bias
    spectrum `bias_spec` (1, 1, F)."""
    spec = stft_complex(audio, N_FFT, HOP, WIN)
    mag = spec.abs()
    mag_d = torch.clamp_min(mag - bias_spec * strength, 0.0)
    return istft(spec * (mag_d / torch.clamp_min(mag, 1e-12)), N_FFT, HOP, WIN)


class Denoiser:
    def __init__(self, vocoder, num_mels: int = 80, device=None):
        mel = torch.zeros((1, 88, num_mels), dtype=torch.float32, device=device)
        with torch.no_grad():
            spec = stft_complex(vocoder(mel), N_FFT, HOP, WIN)
        self.bias_spec = spec[:, 0:1, :].abs()  # (1, 1, F)

    @torch.no_grad()
    def __call__(self, audio: torch.Tensor, strength: float = 0.0005) -> torch.Tensor:
        """audio (B, L) → denoised audio (B, hop · (n_frames − 1))."""
        return denoise(audio, self.bias_spec, strength)
