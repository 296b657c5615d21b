"""Chunked streaming vocoding: audio flows before the whole utterance is
vocoded (PyTorch port of ``emojivoice_tpu.inference.streaming``).

The acoustic model is bidirectional over the utterance (U-Net +
transformers), so the mel is produced in one call; the HiFi-GAN vocoder,
however, is a finite-receptive-field conv stack, so it streams: fixed-size
mel windows with `overlap` context frames on each side are vocoded one by
one, and the interior samples are emitted as they finish.

Time to first audio ≈ t(encoder) + t(CFM decode at the bucket) + t(one
vocoder chunk), instead of the full-utterance vocode.

Streamed audio equals the monolithic call's when `overlap` covers the
vocoder's receptive field in mel frames.  The default 8 is the JAX
package's and does NOT cover HiFi-GAN v1's at full width (its k = 11
res-block alone reaches 60 samples per side at the first stage's 8 samples
per mel frame): what it leaks, and the overlap that leaks nothing, are
measured in ``PERF.md``.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch


class StreamingVocoder:
    def __init__(self, vocoder, chunk_frames: int = 64, overlap: int = 8, vocode_fn=None):
        """``vocode_fn(mel) -> wav`` overrides the vocoder's plain forward:
        the pipeline passes its own ``_vocode`` so chunks take the same path
        (K1 on the card) as monolithic vocoding, and the exactness contract
        compares like with like."""
        self.vocoder = vocoder
        self.chunk_frames = chunk_frames
        self.overlap = overlap
        self.ups = vocoder.cfg.total_upsample
        self.device = next(vocoder.parameters()).device
        self._vocode = vocode_fn if vocode_fn is not None else vocoder

    @torch.no_grad()
    def _window(self, mel: torch.Tensor, lo: int, hi: int, start: int) -> np.ndarray:
        """Vocode mel[lo:hi] and return the chunk_frames·ups samples that
        begin at mel frame `start`, on the host."""
        ups = self.ups
        wav = self._vocode(mel[lo:hi][None])[0]
        return wav[(start - lo) * ups: (start - lo + self.chunk_frames) * ups].cpu().numpy()

    def stream(self, mel, mel_length: Optional[int] = None) -> Iterator[np.ndarray]:
        """mel (T, n_mels), a tensor or an array, with T a multiple of
        chunk_frames (the bucket; zero-padded otherwise) → yields
        chunk_frames·ups-sample chunks, trimmed to mel_length·ups.

        The mel goes to the vocoder's device once; every window is a slice of
        it there.  Three window shapes, clipped at the true array boundaries
        so the convolutions' own zero padding lands exactly where the
        monolithic call pads: first ``ck + ov`` (no left context), middle
        ``ck + 2·ov``, last ``ck + ov`` (no right context); a single-chunk
        utterance is one whole call.

        Exactness contract: concat(stream(mel)) == vocoder(mel)[: ml·ups]
        whenever overlap covers the receptive field (tests pin this).
        """
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        t = mel.shape[0]
        mel_length = t if mel_length is None else mel_length
        ov, ck = self.overlap, self.chunk_frames
        if t % ck != 0:
            mel = torch.nn.functional.pad(mel, (0, 0, 0, ck - t % ck))
            t = mel.shape[0]
        n_chunks = t // ck
        emitted, target = 0, mel_length * self.ups
        for c in range(n_chunks):
            wav = self._window(mel, max(c * ck - ov, 0), min(c * ck + ck + ov, t), c * ck)
            remaining = target - emitted
            if remaining <= 0:
                break
            if remaining < len(wav):
                wav = wav[:remaining]
            emitted += len(wav)
            yield wav


def stream_synthesise(
    pipeline,
    text: str,
    spk: int = 0,
    n_timesteps: int = 10,
    temperature: float = 0.667,
    length_scale: float = 1.0,
    language: Optional[str] = None,
    seed: Optional[int] = None,
    chunk_frames: int = 64,
    overlap: int = 8,
) -> Iterator[np.ndarray]:
    """Generator of waveform chunks for one utterance: the pipeline's
    mel-only call, then a StreamingVocoder over its ``_vocode``."""
    res = pipeline.synthesise(
        [text], spks=[spk], n_timesteps=n_timesteps, temperature=temperature,
        length_scale=length_scale, language=language, seed=seed,
        denoiser_strength=0.0, vocode=False, keep_mel=True,
    )[0]
    sv = getattr(pipeline, "_streaming_vocoder", None)
    if sv is None or sv.chunk_frames != chunk_frames or sv.overlap != overlap:
        sv = StreamingVocoder(pipeline.vocoder, chunk_frames, overlap, vocode_fn=pipeline._vocode)
        pipeline._streaming_vocoder = sv
    yield from sv.stream(res.mel, res.mel_length)


# The policy below is the JAX package's, kept so that `choose_strategy`
# answers as it does there: one full call for a single segment under 8 s of
# predicted audio, chunked streaming above, pipelined segments for
# multi-sentence text.  What each strategy's time to first audio is on the
# H100, at three lengths, is in PERF.md.
STREAM_MIN_AUDIO_S = 8.0
# host-side audio-length estimate: spoken English at the model's default rate
# covers about 14 characters a second; only the full/stream tie-break needs it
CHARS_PER_SECOND = 14.0


def estimate_audio_seconds(text: str, length_scale: float = 1.0) -> float:
    return len(text) / CHARS_PER_SECOND * length_scale


def choose_strategy(text: str, segment_chars: int = 120,
                    length_scale: float = 1.0):
    """Pick the playback strategy for ``text``.

    Returns ``(strategy, segments)`` with strategy ∈ {"full", "pipelined",
    "stream"}.
    """
    from emojivoice_tpu_torch.inference.longform import split_text

    segments = split_text(text, segment_chars)
    if len(segments) > 1:
        return "pipelined", segments
    seg = segments[0] if segments else ""
    if estimate_audio_seconds(seg, length_scale) >= STREAM_MIN_AUDIO_S:
        return "stream", segments
    return "full", segments


def auto_stream(
    pipeline,
    text: str,
    spk: int = 0,
    segment_chars: int = 120,
    gap_seconds: float = 0.15,
    language: Optional[str] = None,
    strategy: Optional[str] = None,
    **synth_kw,
) -> Iterator[np.ndarray]:
    """Yield waveform chunks for ``text`` under the strategy
    ``choose_strategy`` picks (or a forced ``strategy``).  The serving entry
    (`/api/stream`) speaks through this."""
    chosen, segments = choose_strategy(text, segment_chars,
                                       synth_kw.get("length_scale", 1.0))
    if strategy is not None:
        chosen = strategy
    if chosen == "stream" and not hasattr(pipeline, "_vocode"):
        if strategy == "stream":
            raise ValueError("chunked streaming needs a live pipeline "
                             "(a backend without a mel-only call cannot stream)")
        chosen = "full"  # auto degrades gracefully on such a backend
    if chosen == "pipelined":
        from emojivoice_tpu_torch.inference.longform import stream_longform

        yield from stream_longform(pipeline, text, spk=spk,
                                   gap_seconds=gap_seconds, language=language,
                                   max_chars=segment_chars, **synth_kw)
    elif chosen == "stream":
        gap = np.zeros(int(gap_seconds * 22050), np.float32)
        for i, seg in enumerate(segments):
            if i:
                yield gap
            # the chunked vocoder path skips the denoiser (its bias
            # subtraction is a whole-utterance STFT)
            kw = {k: v for k, v in synth_kw.items() if k != "denoiser_strength"}
            yield from stream_synthesise(pipeline, seg, spk=spk,
                                         language=language, **kw)
    else:
        res = pipeline.synthesise([text], spks=[spk], language=language,
                                  **synth_kw)[0]
        yield res.wav
