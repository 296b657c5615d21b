"""WaveGlow-style spectral denoiser (PyTorch port of
``emojivoice_tpu.vocoder.denoiser``).

At construction the vocoder is probed with a mel (1, 88, n_mels), all zeros
(``mode="zeros"``, the default) or standard normal (``mode="normal"``, drawn
from a ``torch.Generator`` seeded 0: the JAX package draws with threefry,
whose bits PyTorch cannot reproduce, so a test hands both the same ``mel``),
and the magnitude of its frame 0 is kept as the bias spectrum.  The probe runs
the vocoder's f32 forward whatever precision the pipeline serves in.  A call
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
    def __init__(self, vocoder, num_mels: int = 80, device=None, mode: str = "zeros",
                 mel: torch.Tensor = None):
        if mode not in ("zeros", "normal"):
            raise ValueError(f"Mode {mode} is not supported")
        if mel is None and mode == "zeros":
            mel = torch.zeros((1, 88, num_mels), dtype=torch.float32)
        elif mel is None:
            mel = torch.randn((1, 88, num_mels), generator=torch.Generator().manual_seed(0))
        mel = mel.to(device=device, dtype=torch.float32)
        with torch.no_grad():
            spec = stft_complex(vocoder(mel), N_FFT, HOP, WIN)
        self.bias_spec = spec[:, 0:1, :].abs()  # (1, 1, F)

    @torch.no_grad()
    def __call__(self, audio: torch.Tensor, strength: float = 0.0005) -> torch.Tensor:
        """audio (B, L) → denoised audio (B, hop · (n_frames − 1))."""
        return denoise(audio, self.bias_spec, strength)
