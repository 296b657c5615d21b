"""End-to-end synthesis pipeline, text → waveform (PyTorch port of
``emojivoice_tpu.inference.pipeline``).

The chain: text → ids (``text/``) → TextEncoder + duration head → host
read of the predicted mel length → mel bucket → ``generate_path`` → Euler
CFM decode → HiFi-GAN (K1 on every MRF stage on the card) → spectral
denoiser → optional on-device pcm16.

* **Two-stage** (default): stage A runs the encoder; the host reads
  ``max(y_lengths)`` (one sync) and picks ``pick_bucket(fix_len_compatibility(·))``;
  stage B decodes, vocodes and denoises at that mel bucket.
* **Fused** (``fused=True``): one pass at a fixed mel capacity with no host
  read in between.

Precision (opt-in, as in the JAX package; f32 is the default and the oracle):

* ``vocoder_dtype=torch.bfloat16`` runs only the vocoder in bf16: K1's bf16
  mode on every MRF stage (``vocoder/hifigan.py``); the mel is the f32 one.
* ``compute_dtype=torch.bfloat16`` runs the acoustic model in bf16 too.  In
  two-stage mode the encoder and durations stay f32 (the JAX stage A casts
  nothing) and stage B decodes in bf16 from ``mu_x``, ``x_mask`` and the
  speaker embedding cast down; fused, the encoder runs in bf16 as well.  The
  vocoder then runs K1's bf16 mode whatever ``vocoder_dtype`` says.

Either way the noise is drawn in f32, durations and the alignment path are
f32, the denoiser's bias probe runs the f32 vocoder, and mel and wav come back
in f32.  Parameters stay f32 at rest: where JAX casts inside the compiled
program, an eager per-call cast would cost a launch per tensor, so the pipeline
makes its bf16 copy of the acoustic model once, at construction
(``compute_model``; load new weights into a new pipeline), and the vocoder
packs K1's bf16 operands once per weights.  Export ignores both switches, as
the JAX package's does.

A pipeline may hold no vocoder (``vocoder_cfg=None``, ``vocoder=None``,
``from_random(with_vocoder=False)``): it then has no denoiser either, serves
mels only, and ``vocode=True`` raises.

PyTorch runs eagerly, so ``synthesise_async`` returns once the work is
enqueued on the device stream (the two-stage host read aside): the inputs go
up from pinned host memory without a wait, and the copies of its outputs
into pinned host memory are enqueued too, and ``finalize`` waits for
this batch's copies only: work enqueued later, by this thread or another,
does not delay it.  Each call records when every stage ended (CUDA events
on the card, the host clock on the CPU) and reports per-stage milliseconds
beside the reference RTF formulas.
"""

from __future__ import annotations

import copy
import dataclasses
import time
import warnings
from typing import Any, Optional, Sequence

import numpy as np
import torch

from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch import text as textlib
from emojivoice_tpu_torch.models.matcha import MatchaTTS
from emojivoice_tpu_torch.utils.buckets import default_mel_buckets, default_text_buckets, pick_bucket
from emojivoice_tpu_torch.utils.masks import fix_len_compatibility, intersperse
from emojivoice_tpu_torch.utils.prng import synthesis_noise
from emojivoice_tpu_torch.utils.timing import StageClock
from emojivoice_tpu_torch.vocoder.denoiser import Denoiser
from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator

HOP_LENGTH = 256
SAMPLE_RATE = 22050


@dataclasses.dataclass
class SynthesisResult:
    wav: np.ndarray  # (samples,) float32 in [-1, 1]
    mel: np.ndarray  # (T_mel, n_feats), denormalized
    mel_length: int
    rtf: float  # acoustic-only, reference formula
    rtf_w: float  # with vocoder
    cleaned_text: str = ""
    sample_rate: int = SAMPLE_RATE
    stage_ms: dict = dataclasses.field(default_factory=dict)  # the whole batch's, per stage


def upload(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor onto `device`.  To the card from pinned memory without
    waiting: a copy from pageable memory waits for the stream."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def to_host_async(out: dict) -> tuple:
    """Enqueue the device→host copies of `out`'s tensors into pinned memory,
    behind the work that made them and ahead of whatever is enqueued next (a
    ``.cpu()`` later would queue behind all later work on the stream) →
    (host tensors, the CUDA event recorded after the copies).  On the CPU:
    (out, None)."""
    if not any(v.is_cuda for v in out.values()):
        return out, None
    out = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True).copy_(v, non_blocking=True)
           for k, v in out.items()}
    done = torch.cuda.Event(enable_timing=True)  # timed: the gap to the next batch's start can be read
    done.record()
    return out, done


@dataclasses.dataclass
class PendingSynthesis:
    """Synthesis enqueued on the device; ``SynthesisPipeline.finalize``
    waits for it and builds the results."""

    out: dict  # host tensors (pinned, being filled, on the card; the outputs themselves on the CPU)
    cleaned: list
    b: int
    t0: float
    clock: StageClock
    done: Any = None  # CUDA event recorded after the copies; None on the CPU


class SynthesisPipeline:
    def __init__(self, model_cfg: cfglib.ModelConfig, model: MatchaTTS,
                 vocoder_cfg: Optional[cfglib.HiFiGANConfig] = None, vocoder: Optional[HiFiGANGenerator] = None,
                 text_buckets: Sequence[int] = None, mel_buckets: Sequence[int] = None,
                 cleaners: Sequence[str] = ("english_cleaners2",), device="cuda", denoiser_mode: str = "zeros",
                 compute_dtype: torch.dtype = torch.float32, vocoder_dtype: torch.dtype = torch.float32):
        """`denoiser_mode` "zeros" or "normal" picks the denoiser's bias probe;
        `compute_dtype` and `vocoder_dtype` are f32 or bf16 (module docstring)."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError('SynthesisPipeline: no CUDA device is available (pass device="cpu" to synthesise '
                               'on the CPU)')
        if (vocoder_cfg is None) != (vocoder is None):
            raise ValueError("SynthesisPipeline: give both vocoder_cfg and vocoder, or neither (a mel-only pipeline)")
        for name, dtype in (("compute_dtype", compute_dtype), ("vocoder_dtype", vocoder_dtype)):
            if dtype not in (torch.float32, torch.bfloat16):
                raise ValueError(f"SynthesisPipeline: {name}={dtype}; expected torch.float32 or torch.bfloat16")
        self.model_cfg = model_cfg
        self.model = model.to(self.device).eval()
        self.compute_dtype, self.vocoder_dtype = compute_dtype, vocoder_dtype
        # the acoustic model in the compute dtype: a copy made once, or the model itself.  The time MLP computes
        # in f32 on the rounded weights, as JAX's f32 input promotes them, so it holds them as f32 and casts nothing
        self.compute_model = self.model
        if compute_dtype != torch.float32:
            self.compute_model = copy.deepcopy(self.model).to(compute_dtype)
            self.compute_model.decoder.estimator.time_mlp.float()
        # K1's mode: bf16 whenever either switch is
        self.vocode_dtype = torch.bfloat16 if torch.bfloat16 in (compute_dtype, vocoder_dtype) else torch.float32
        self.vocoder_cfg = vocoder_cfg
        self.vocoder = vocoder.to(self.device).eval() if vocoder is not None else None
        self.text_buckets = tuple(text_buckets or default_text_buckets())
        self.mel_buckets = tuple(mel_buckets or default_mel_buckets())
        self.cleaners = tuple(cleaners)
        # the bias probe runs the f32 vocoder in every precision
        self.denoiser = (Denoiser(self.vocoder, num_mels=model_cfg.n_feats, device=self.device, mode=denoiser_mode)
                         if self.vocoder is not None else None)

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #

    @classmethod
    def from_random(cls, root_cfg: Optional[cfglib.RootConfig] = None, seed: int = 0, device="cuda",
                    with_vocoder: bool = True, **kw):
        """Random-init pipeline, seeded (tests and the chip smoke run without
        released weights).  Modules are built on the CPU under a forked RNG
        seeded with `seed`, then moved to `device`: the card unless the caller
        asks for ``device="cpu"``.  ``with_vocoder=False`` gives a mel-only
        pipeline with the same acoustic weights."""
        root_cfg = root_cfg or cfglib.get_preset("emoji_multi")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = MatchaTTS(root_cfg.model)
            vocoder = HiFiGANGenerator(root_cfg.vocoder) if with_vocoder else None
        return cls(root_cfg.model, model, root_cfg.vocoder if with_vocoder else None, vocoder, device=device, **kw)

    @classmethod
    def from_state_dicts(cls, model_cfg: cfglib.ModelConfig, matcha_sd: dict,
                         vocoder_cfg: cfglib.HiFiGANConfig, hifigan_sd: dict, **kw):
        """Pipeline from reference-named float32 state dicts (tensors or numpy
        arrays), loaded with strict name matching; on the card unless `kw`
        holds ``device="cpu"``."""
        def tensors(sd):
            return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in sd.items()}

        model = MatchaTTS(model_cfg)
        model.load_state_dict(tensors(matcha_sd), strict=True)
        vocoder = HiFiGANGenerator(vocoder_cfg)
        vocoder.load_state_dict(tensors(hifigan_sd), strict=True)
        return cls(model_cfg, model, vocoder_cfg, vocoder, **kw)

    @classmethod
    def _with_vocoder(cls, model_cfg, matcha_sd, vocoder_cfg, vocoder_ckpt, what, **kw):
        """Pipeline from a MatchaTTS state dict and a HiFi-GAN dump; with no
        dump, a random HiFi-GAN from seed 0 (and a warning)."""
        model = MatchaTTS(model_cfg)
        model.load_state_dict(matcha_sd, strict=True)
        if vocoder_ckpt is None:
            warnings.warn(f"{what}: no vocoder checkpoint given; vocoding with a random HiFi-GAN (seed 0), "
                          f"whose audio is noise shaped by the mel")
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(0)
                vocoder = HiFiGANGenerator(vocoder_cfg)
        else:
            from emojivoice_tpu_torch.io.torch_ckpt import load_hifigan

            vocoder = HiFiGANGenerator(vocoder_cfg)
            vocoder.load_state_dict(load_hifigan(vocoder_ckpt), strict=True)
        return cls(model_cfg, model, vocoder_cfg, vocoder, **kw)

    @classmethod
    def from_torch_checkpoints(cls, matcha_ckpt: str, vocoder_ckpt: Optional[str] = None,
                               vocoder_cfg: Optional[cfglib.HiFiGANConfig] = None, **kw):
        """Load reference-format checkpoints: a MatchaTTS ``.ckpt`` (its
        ModelConfig is inferred from shapes and embedded hyper-parameters) and
        a HiFi-GAN generator dump.  `vocoder_cfg` says which generator the dump
        holds (a dump does not) and defaults to HiFi-GAN v1 at the model's mel
        width.  The pipeline always holds a vocoder: with
        ``vocoder_ckpt=None`` it is a seeded random one.  On the card unless
        `kw` holds ``device="cpu"``."""
        from emojivoice_tpu_torch.io.torch_ckpt import load_matcha

        matcha_sd, model_cfg = load_matcha(matcha_ckpt)
        if vocoder_cfg is None:
            vocoder_cfg = dataclasses.replace(cfglib.HiFiGANConfig(), num_mels=model_cfg.n_feats)
        return cls._with_vocoder(model_cfg, matcha_sd, vocoder_cfg, vocoder_ckpt, "from_torch_checkpoints", **kw)

    @classmethod
    def from_checkpoint(cls, ckpt_dir: str, vocoder_ckpt: Optional[str] = None, step: Optional[int] = None, **kw):
        """Serve a model trained by ``emojivoice_tpu_torch.training.train``:
        restores the weights of `step` (the latest by default) and the
        RootConfig beside them from the checkpoint directory (``ckpts/`` under
        ``--out_dir``).  The vocoder comes from a HiFi-GAN dump; with
        ``vocoder_ckpt=None`` it is a seeded random one of the run's vocoder
        config.  On the card unless `kw` holds ``device="cpu"``."""
        from emojivoice_tpu_torch.io.checkpoint import CheckpointManager

        mgr = CheckpointManager(ckpt_dir)
        root_cfg = mgr.load_config()
        restored = mgr.restore(step)
        matcha_sd = restored["model"] if "model" in restored else restored
        return cls._with_vocoder(root_cfg.model, matcha_sd, root_cfg.vocoder, vocoder_ckpt, "from_checkpoint", **kw)

    # ------------------------------------------------------------------ #
    # stages
    # ------------------------------------------------------------------ #

    def encode_texts(self, texts: Sequence[str], language: Optional[str] = None):
        """Host-side text processing for a padded batch → (x, lengths, cleaned, t_bucket)."""
        cleaners = self.cleaners
        if language is not None:
            from emojivoice_tpu_torch.text.cleaners import LANGUAGE_CLEANERS

            if language not in LANGUAGE_CLEANERS:
                raise KeyError(f"Unknown language {language!r}; available: {sorted(LANGUAGE_CLEANERS)}")
            cleaners = (LANGUAGE_CLEANERS[language].__name__,)
        seqs, lengths, cleaned = [], [], []
        for t in texts:
            ids, c = textlib.text_to_sequence(t, cleaners)
            ids = intersperse(ids, 0)
            seqs.append(ids)
            lengths.append(len(ids))
            cleaned.append(c)
        t_bucket = pick_bucket(max(lengths), self.text_buckets)
        x = np.zeros((len(texts), t_bucket), np.int64)
        for i, ids in enumerate(seqs):
            x[i, : len(ids)] = ids
        return x, np.asarray(lengths, np.int64), cleaned, t_bucket

    def _speakers(self, spks, b: int) -> Optional[torch.Tensor]:
        if self.model_cfg.n_spks <= 1:
            return None
        raw = np.asarray(spks if spks is not None else [0] * b, np.int64)
        # out-of-range ids are clamped like the JAX pipeline's robust lookup
        return upload(torch.from_numpy(np.clip(raw, 0, self.model_cfg.n_spks - 1)), self.device)

    @torch.no_grad()
    def _vocode(self, mel: torch.Tensor) -> torch.Tensor:
        """The pipeline's vocoder call, mel (B, T, n_feats) → wav (B, T·hop)
        f32: K1 on every MRF stage on the card, in bf16 mode where the
        pipeline's precision says so.  Chunked streaming vocodes through it,
        so streamed and monolithic audio come from the same kernels."""
        return self.vocoder(mel.float(), compute_dtype=self.vocode_dtype)

    @torch.no_grad()
    def _vocode_denoise_pcm(self, mel, denoise: bool, denoiser_strength: float, pcm16: bool, clock):
        wav = self._vocode(mel)
        clock.mark("vocoder")
        if denoise:
            wav = self.denoiser(wav, denoiser_strength)
            clock.mark("denoiser")
        if pcm16:
            # on device, before the copy: clip, scale, truncating cast
            wav = (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
        return wav

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    def synthesise(self, texts: Sequence[str], spks: Optional[Sequence[int]] = None, n_timesteps: int = 10,
                   temperature: float = 0.667, length_scale: float = 1.0, denoiser_strength: float = 0.00025,
                   language: Optional[str] = None, seed=None, fused: bool = False,
                   fused_mel_bucket: Optional[int] = None, keep_mel: bool = True, vocode: bool = True,
                   pcm16: bool = False) -> list[SynthesisResult]:
        """Synthesise a padded batch of texts.  ``seed`` is one int (one
        generator for the batch) or one int per row (each row's noise depends
        on its own seed only)."""
        return self.finalize(self.synthesise_async(
            texts, spks=spks, n_timesteps=n_timesteps, temperature=temperature, length_scale=length_scale,
            denoiser_strength=denoiser_strength, language=language, seed=seed, fused=fused,
            fused_mel_bucket=fused_mel_bucket, keep_mel=keep_mel, vocode=vocode, pcm16=pcm16))

    @torch.no_grad()
    def synthesise_async(self, texts: Sequence[str], spks: Optional[Sequence[int]] = None, n_timesteps: int = 10,
                         temperature: float = 0.667, length_scale: float = 1.0,
                         denoiser_strength: float = 0.00025, language: Optional[str] = None, seed=None,
                         fused: bool = False, fused_mel_bucket: Optional[int] = None, keep_mel: bool = True,
                         vocode: bool = True, pcm16: bool = False) -> PendingSynthesis:
        """Enqueue the synthesis, and the copies of its outputs to the host,
        without waiting for them.

        In two-stage mode the call blocks once, where the host reads the
        predicted mel length after the encoder: on one CUDA stream that read
        returns when everything enqueued before it has finished, an earlier
        batch included.  So a caller that dispatches batch N+1 before it
        finalizes batch N (the serving engine, long-form) overlaps N's copies
        and its own host work with N+1's decode and vocoding, but not N's
        compute with N+1's: "async" is one encoder deep.  A fused call waits
        nowhere."""
        if vocode and self.vocoder is None:
            raise ValueError("this pipeline has no vocoder: it serves mels only (pass vocode=False)")
        t0 = time.perf_counter()
        x_np, xl_np, cleaned, _ = self.encode_texts(texts, language)
        b = x_np.shape[0]
        if seed is None:
            seed = int(np.random.randint(0, 2**31))
        clock = StageClock(self.device)
        x = upload(torch.from_numpy(x_np), self.device)
        x_lengths = upload(torch.from_numpy(xl_np), self.device)
        spk = self._speakers(spks, b)

        # fused, the encoder runs in the compute dtype; two-stage, stage A stays f32 (the JAX stage A casts nothing)
        enc = (self.compute_model if fused else self.model).encode_text(x, x_lengths, spk, length_scale)
        clock.mark("encoder")
        if fused:
            m_bucket = fused_mel_bucket or self.mel_buckets[-1]
        else:
            # the host sync: the predicted mel length picks the mel bucket
            y_len_max = int(enc[2].max().item())
            m_bucket = pick_bucket(fix_len_compatibility(y_len_max), self.mel_buckets)
            if self.compute_dtype != torch.float32:  # stage B's inputs in the compute dtype, as the JAX stage B casts
                mu_x, w_ceil, y_lengths, x_mask, spk_e = enc
                dt = self.compute_dtype
                enc = (mu_x.to(dt), w_ceil, y_lengths, x_mask.to(dt), spk_e.to(dt) if spk_e is not None else None)
        z = synthesis_noise(seed, b, m_bucket, self.model_cfg.n_feats, temperature, self.device)  # f32
        dec = self.compute_model.decode_mel(*enc, m_bucket, n_timesteps, z)
        clock.mark("decoder")

        out = {"mel_lengths": dec["mel_lengths"]}
        if keep_mel:
            out["mel"] = dec["mel"].float()
        if vocode:
            out["wav"] = self._vocode_denoise_pcm(dec["mel"], denoiser_strength > 0, denoiser_strength, pcm16,
                                                  clock)
        out, done = to_host_async(out)
        return PendingSynthesis(out=out, cleaned=cleaned, b=b, t0=t0, clock=clock, done=done)

    def finalize(self, p: PendingSynthesis) -> list[SynthesisResult]:
        """Wait for an enqueued batch's host copies and build the results.
        The RTF clock spans enqueue → copy of this batch."""
        if p.done is not None:
            p.done.synchronize()  # this batch's copies only, not the stream's later work
        out = {k: v.numpy() for k, v in p.out.items()}
        t_total = time.perf_counter() - p.t0
        stage_ms = p.clock.elapsed_ms()
        results = []
        for i in range(p.b):
            ml = int(out["mel_lengths"][i])
            mel = out["mel"][i][:ml] if "mel" in out else np.zeros((0, 0), np.float32)
            wav = None
            if "wav" in out:
                raw = out["wav"][i][: ml * self.vocoder_cfg.total_upsample]
                wav = raw.astype(np.float32) / 32767.0 if raw.dtype == np.int16 else raw.astype(np.float32)
            # reference RTF formulas (matcha_tts.py:142-143, cli.py:301-302)
            rtf = t_total * SAMPLE_RATE / (max(ml, 1) * HOP_LENGTH) / p.b
            rtf_w = (t_total * SAMPLE_RATE / max(len(wav), 1) / p.b) if wav is not None else float("nan")
            results.append(SynthesisResult(
                wav=wav if wav is not None else np.zeros(0, np.float32), mel=mel, mel_length=ml, rtf=rtf,
                rtf_w=rtf_w, cleaned_text=p.cleaned[i], stage_ms=stage_ms))
        return results

    def warmup(self, n_timesteps: int = 10, batch: int = 1, fused: bool = False, keep_mel: bool = True,
               vocode: bool = True, pcm16: bool = False):
        """Run one short request with the serving flags (first-call
        allocations, cuFFT plans and the kernel build happen here)."""
        self.synthesise(["a " * 10] * batch, spks=[0] * batch if self.model_cfg.n_spks > 1 else None,
                        n_timesteps=n_timesteps, seed=0, fused=fused, keep_mel=keep_mel, vocode=vocode,
                        pcm16=pcm16)
