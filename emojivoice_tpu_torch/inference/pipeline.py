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

**The vocoder's reach.**  On one device (no mesh) a call vocodes each row
only as far as its served audio depends on it: from the decoder's
``mel_lengths`` on the device (no host read, fused or not) it builds each
row's served frames, 0 for a pad row (``synthesise_async(live_rows=)``: the
serving engine's pad rows), and the vocoder turns them into each MRF stage's
reach (``HiFiGANGenerator.stage_reach``, with the margin for what this
pipeline's denoiser reads past the served end, ``denoiser.read_past``).
K1 computes only the tiles before the reach and leaves the rest of the
padded wav unwritten (``ops/mrf.py``); every served sample, [0, L·hop) of a
live row, has the bits it has without a reach, and ``finalize`` returns the
live rows only.  Streaming windows (``_vocode`` called without served
frames), the denoiser's bias probe, the exported bundle and the mesh path
vocode every frame.  The two-stage host read brings back every row's
predicted length in its one sync, and ``PendingSynthesis`` carries the
row-frames K1 covers and the row-frames of the padded call.

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
beside the reference RTF formulas; its ``PendingSynthesis`` carries the
host's seconds in the text frontend and in the two-stage host read.  With
the recorder of ``utils/observability.py`` enabled, ``synthesise_async``
records on the calling thread ``pipeline.frontend`` (``encode_texts``),
``pipeline.stage_a`` (the inputs' upload and the encoder),
``pipeline.host_read`` (the read that picks the mel bucket) and
``pipeline.launch`` (the noise, the decoder, vocoder and denoiser, and the
host copies enqueued).

**Through captured CUDA graphs** (``graphs=``; the default on a CUDA device
without a mesh, as ``jax.jit`` is the reference's default): each stage of a
call is one graph per bucket key (``inference/graphs.py``), replayed from
static buffers: encoder + durations keyed (text bucket, batch, speakers,
dtype), the CFM decode (text bucket, mel bucket, batch, steps, dtype), the
vocoder with K1 on every MRF stage (batch, frames, K1's mode: streaming
windows replay it too) and the denoiser with the pcm16 cast (batch, samples,
denoise, pcm16).  A call is then about four graph launches where the eager
path makes thousands of kernel launches; the clock marks between the graphs
keep ``stage_ms``'s keys, and the two-stage host read stays between stage A
and stage B.  The noise is drawn outside the graphs and copied in with the
ids, lengths, speakers, ``length_scale`` and ``denoiser_strength``.  A key is
captured at its first use (``warmup`` captures what its request hits), new
weights drop the graphs, and the store's lock serializes a call's copies in,
replays and copies out against other threads (the webapp's handlers).
``graphs=False`` keeps the eager path (the CPU's default, for tests and A/B
timing); on the CPU ``graphs=True`` runs the same staging without capturing.

**Over a mesh** (``mesh=``, a ``parallel/mesh.py`` mesh over ranks that each
build the same pipeline and make the same calls): the acoustic model and the
vocoder are laid out by ``parallel/tp.py``'s rules on the model axis (the
vocoder's slices are gathered once for K1, ``vocoder/hifigan.py``), and a
batch that divides the data axis is split by rows: each rank encodes,
decodes, vocodes (K1 on its rows) and denoises its own rows, the mel bucket
is the global batch's (the ranks' longest predicted lengths are reduced to
one), each row's noise is what the one-device call draws for it, and the
outputs are all-gathered, so every rank returns the whole result.  A batch
that does not divide the data axis runs replicated on every rank, as the JAX
pipeline runs it; the model axis still splits its products.
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
from emojivoice_tpu_torch.inference.graphs import GraphStore
from emojivoice_tpu_torch.models.matcha import MatchaTTS
from emojivoice_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, collectives, gather_rows, rows
from emojivoice_tpu_torch.parallel.tp import shard_params
from emojivoice_tpu_torch.utils import observability as obs
from emojivoice_tpu_torch.utils.buckets import default_mel_buckets, default_text_buckets, pick_bucket
from emojivoice_tpu_torch.utils.masks import fix_len_compatibility, intersperse
from emojivoice_tpu_torch.utils.prng import synthesis_noise
from emojivoice_tpu_torch.utils.timing import StageClock
from emojivoice_tpu_torch.vocoder.denoiser import Denoiser, read_past
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
    frontend_s: float = 0.0  # the host's text frontend (``encode_texts``), seconds
    host_read_s: float = 0.0  # the host read of the predicted mel length (0 fused), seconds
    live: Optional[int] = None  # rows [0, live) are served (None: all); the rest are pad rows
    # mel-rate row-frames of the vocoder's MRF stages: those K1 computes, the live rows' reach with the widest
    # stage margin (at most the bucket; the whole call without a reach), and those of the padded call
    # (batch × mel bucket); both 0 where no host read tells the lengths (fused, a mesh's data axis) or nothing
    # is vocoded
    k1_frames_live: int = 0
    k1_frames_all: int = 0


class SynthesisPipeline:
    def __init__(self, model_cfg: cfglib.ModelConfig, model: MatchaTTS,
                 vocoder_cfg: Optional[cfglib.HiFiGANConfig] = None, vocoder: Optional[HiFiGANGenerator] = None,
                 text_buckets: Sequence[int] = None, mel_buckets: Sequence[int] = None,
                 cleaners: Sequence[str] = ("english_cleaners2",), device="cuda", denoiser_mode: str = "zeros",
                 compute_dtype: torch.dtype = torch.float32, vocoder_dtype: torch.dtype = torch.float32,
                 mesh: Optional[Mesh] = None, graphs: Optional[bool] = None):
        """`denoiser_mode` "zeros" or "normal" picks the denoiser's bias probe;
        `compute_dtype` and `vocoder_dtype` are f32 or bf16; `mesh` serves
        over ranks (module docstring; `device` is then this rank's); `graphs`
        serves through captured CUDA graphs (module docstring): on by default
        on a CUDA device without a mesh, off otherwise; True on the CPU runs
        the graph path's staging without capturing."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError('SynthesisPipeline: no CUDA device is available (pass device="cpu" to synthesise '
                               'on the CPU)')
        if graphs and mesh is not None:
            raise ValueError("SynthesisPipeline: graphs=True with a mesh: serving over a mesh runs eagerly (its "
                             "collectives are not captured); pass graphs=False or no mesh")
        if graphs is None:
            graphs = self.device.type == "cuda" and mesh is None
        if (vocoder_cfg is None) != (vocoder is None):
            raise ValueError("SynthesisPipeline: give both vocoder_cfg and vocoder, or neither (a mel-only pipeline)")
        for name, dtype in (("compute_dtype", compute_dtype), ("vocoder_dtype", vocoder_dtype)):
            if dtype not in (torch.float32, torch.bfloat16):
                raise ValueError(f"SynthesisPipeline: {name}={dtype}; expected torch.float32 or torch.bfloat16")
        self.model_cfg = model_cfg
        self.mesh = mesh
        self.model = model.to(self.device).eval()
        if mesh is not None:
            shard_params(self.model, mesh)
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
        if mesh is not None and self.vocoder is not None:
            shard_params(self.vocoder, mesh)
        self.text_buckets = tuple(text_buckets or default_text_buckets())
        self.mel_buckets = tuple(mel_buckets or default_mel_buckets())
        self.cleaners = tuple(cleaners)
        # the bias probe runs the f32 vocoder in every precision
        self.denoiser = (Denoiser(self.vocoder, num_mels=model_cfg.n_feats, device=self.device, mode=denoiser_mode)
                         if self.vocoder is not None else None)
        # samples past a row's served end that the denoiser reads, and the widest margin of mel frames an MRF
        # stage computes past a row's served frames (K1 runs ResBlock1 stages only)
        self.vocode_tail = read_past(vocoder_cfg.total_upsample) if self.vocoder is not None else 0
        self.k1_margin = (max(self.vocoder.reach_margins(self.vocode_tail))
                          if self.vocoder is not None and vocoder_cfg.resblock == "1" else None)
        self.graphs = GraphStore(self.device) if graphs else None

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
        step = step if step is not None else mgr.latest_step()
        # a sharded step (a parallel run's) is read whole into a one-device model's state dict
        template = {"model": MatchaTTS(root_cfg.model).state_dict()} if step is not None and mgr.is_sharded(step) \
            else None
        restored = mgr.restore(step, template=template)
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
    def _vocode(self, mel: torch.Tensor, served: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The pipeline's vocoder call, mel (B, T, n_feats) → wav (B, T·hop)
        f32: K1 on every MRF stage on the card, in bf16 mode where the
        pipeline's precision says so; with `served` ((B,) int32 on the
        device) only as far as each row's served frames need (the module
        docstring).  Chunked streaming vocodes through it, so streamed and
        monolithic audio come from the same kernels, and through one graph
        per (batch, frames, dtype) where the pipeline serves through graphs,
        `served` copied in like the mel."""
        if self.graphs is None:
            return self._vocoder_fn(mel, served)
        with self.graphs.lock:
            return self.graphs.run(("vocoder", mel.shape[0], mel.shape[1], self.vocode_dtype), self._vocoder_fn,
                                   (mel, served), weights=(self.vocoder,))[0]

    def _vocoder_fn(self, mel: torch.Tensor, served: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.vocoder(mel.float(), compute_dtype=self.vocode_dtype, served=served, tail=self.vocode_tail)

    @staticmethod
    def _served(mel_lengths: torch.Tensor, live: int) -> torch.Tensor:
        """Each row's served mel frames on the device: its mel length, 0 for
        a pad row (rows from `live` on)."""
        served = mel_lengths.to(torch.int32)
        if live == served.shape[0]:
            return served
        served = served.clone()
        served[live:] = 0
        return served

    def _k1_frames(self, lengths, live: int, m_bucket: int, served: bool) -> tuple[int, int]:
        """(row-frames K1 covers, row-frames of the padded call) at the mel
        rate, from the rows' predicted lengths the host read (None: not
        read)."""
        if lengths is None or self.k1_margin is None:
            return 0, 0
        every = len(lengths) * m_bucket
        if not served:
            return every, every
        return int(np.minimum(np.asarray(lengths[:live], np.int64) + self.k1_margin, m_bucket).sum()), every

    def _post_fn(self, denoise: bool, pcm16: bool):
        """The stage after the vocoder: the denoiser at a runtime strength,
        then the pcm16 cast."""
        def post(wav, strength):
            if denoise:
                wav = self.denoiser(wav, strength)
            if pcm16:
                # on device, before the copy: clip, scale, truncating cast
                wav = (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
            return wav
        return post

    @torch.no_grad()
    def _vocode_denoise_pcm(self, mel, denoise: bool, denoiser_strength: float, pcm16: bool, clock, served=None):
        """The vocoder (over `served` frames of each row where given), then
        the denoiser and the pcm16 cast as one stage (one graph keyed (batch,
        samples, denoise, pcm16) through graphs)."""
        wav = self._vocode(mel, served)
        clock.mark("vocoder")
        if denoise or pcm16:
            post = self._post_fn(denoise, pcm16)
            if self.graphs is None:
                wav = post(wav, denoiser_strength)
            else:
                wav, = self.graphs.run(("denoiser", wav.shape[0], wav.shape[1], denoise, pcm16), post,
                                       (wav, float(denoiser_strength)), weights=(self.denoiser.bias_spec,))
            if denoise:
                clock.mark("denoiser")
        return wav

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    def synthesise(self, texts: Sequence[str], spks: Optional[Sequence[int]] = None, n_timesteps: int = 10,
                   temperature: float = 0.667, length_scale: float = 1.0, denoiser_strength: float = 0.00025,
                   language: Optional[str] = None, seed=None, fused: bool = False,
                   fused_mel_bucket: Optional[int] = None, keep_mel: bool = True, vocode: bool = True,
                   pcm16: bool = False, live_rows: Optional[int] = None) -> list[SynthesisResult]:
        """Synthesise a padded batch of texts.  ``seed`` is one int (one
        generator for the batch) or one int per row (each row's noise depends
        on its own seed only)."""
        return self.finalize(self.synthesise_async(
            texts, spks=spks, n_timesteps=n_timesteps, temperature=temperature, length_scale=length_scale,
            denoiser_strength=denoiser_strength, language=language, seed=seed, fused=fused,
            fused_mel_bucket=fused_mel_bucket, keep_mel=keep_mel, vocode=vocode, pcm16=pcm16, live_rows=live_rows))

    @torch.no_grad()
    def synthesise_async(self, texts: Sequence[str], spks: Optional[Sequence[int]] = None, n_timesteps: int = 10,
                         temperature: float = 0.667, length_scale: float = 1.0,
                         denoiser_strength: float = 0.00025, language: Optional[str] = None, seed=None,
                         fused: bool = False, fused_mel_bucket: Optional[int] = None, keep_mel: bool = True,
                         vocode: bool = True, pcm16: bool = False, live_rows: Optional[int] = None) -> PendingSynthesis:
        """Enqueue the synthesis, and the copies of its outputs to the host,
        without waiting for them.  Rows from `live_rows` on are pad rows
        (None: none are): nothing of theirs is vocoded where the pipeline
        vocodes by reach, and ``finalize`` returns no result for them.

        In two-stage mode the call blocks once, where the host reads the
        predicted mel length after the encoder: on one CUDA stream that read
        returns when everything enqueued before it has finished, an earlier
        batch included.  So a caller that dispatches batch N+1 before it
        finalizes batch N (the serving engine, long-form) overlaps N's copies
        and its own host work with N+1's decode and vocoding, but not N's
        compute with N+1's: "async" is one encoder deep.  A fused call waits
        nowhere.  Over a mesh the host read is a reduction over the data
        axis as well (module docstring)."""
        if vocode and self.vocoder is None:
            raise ValueError("this pipeline has no vocoder: it serves mels only (pass vocode=False)")
        t0 = time.perf_counter()
        with obs.span("pipeline.frontend"):
            x_np, xl_np, cleaned, _ = self.encode_texts(texts, language)
        frontend_s = time.perf_counter() - t0
        b = x_np.shape[0]
        live = b if live_rows is None else int(live_rows)
        if not 0 < live <= b:
            raise ValueError(f"synthesise_async: live_rows={live_rows} for a batch of {b} rows")
        if seed is None:
            if self.mesh is not None:
                raise ValueError("over a mesh every rank must draw the same noise: pass a seed")
            seed = int(np.random.randint(0, 2**31))
        if self.graphs is not None:
            with self.graphs.lock:
                out, done, clock, host_read_s, k1_frames = self._staged(
                    x_np, xl_np, spks, seed, n_timesteps, temperature, length_scale, denoiser_strength, fused,
                    fused_mel_bucket, keep_mel, vocode, pcm16, live)
            return PendingSynthesis(out=out, cleaned=cleaned, b=b, t0=t0, clock=clock, done=done,
                                    frontend_s=frontend_s, host_read_s=host_read_s, live=live,
                                    k1_frames_live=k1_frames[0], k1_frames_all=k1_frames[1])
        clock = StageClock(self.device)
        # over a mesh whose data axis divides the batch, this rank's rows; all of them otherwise
        group = self.mesh.group(DATA_AXIS) if self.mesh is not None and b % self.mesh.size(DATA_AXIS) == 0 \
            and self.mesh.size(DATA_AXIS) > 1 else None
        mine = rows(self.mesh if group is not None else None, b)
        with obs.span("pipeline.stage_a"):
            x = upload(torch.from_numpy(x_np[mine]), self.device)
            x_lengths = upload(torch.from_numpy(xl_np[mine]), self.device)
            spk = self._speakers(spks, b)
            spk = spk[mine] if spk is not None else None

            # fused, the encoder runs in the compute dtype; two-stage, stage A stays f32 (the JAX stage A casts nothing)
            enc = (self.compute_model if fused else self.model).encode_text(x, x_lengths, spk, length_scale)
            clock.mark("encoder")
        host_read_s, lengths = 0.0, None
        if fused:
            m_bucket = fused_mel_bucket or self.mel_buckets[-1]
        else:
            m_bucket, host_read_s, lengths = self._mel_bucket(enc[2], group)
            if self.compute_dtype != torch.float32:  # stage B's inputs in the compute dtype, as the JAX stage B casts
                mu_x, w_ceil, y_lengths, x_mask, spk_e = enc
                dt = self.compute_dtype
                enc = (mu_x.to(dt), w_ceil, y_lengths, x_mask.to(dt), spk_e.to(dt) if spk_e is not None else None)
        with obs.span("pipeline.launch"):
            z = synthesis_noise(seed, b, m_bucket, self.model_cfg.n_feats, temperature, self.device)[mine]  # f32
            dec = self.compute_model.decode_mel(*enc, m_bucket, n_timesteps, z)
            clock.mark("decoder")

            out = {"mel_lengths": dec["mel_lengths"]}
            if keep_mel:
                out["mel"] = dec["mel"].float()
            if vocode:
                # by reach on one device; over a mesh every frame
                served = self._served(dec["mel_lengths"], live) if self.mesh is None else None
                out["wav"] = self._vocode_denoise_pcm(dec["mel"], denoiser_strength > 0, denoiser_strength, pcm16,
                                                      clock, served)
            out = {k: gather_rows(v, group) for k, v in out.items()}
            out, done = to_host_async(out)
        live_frames, all_frames = self._k1_frames(lengths, live, m_bucket, self.mesh is None) if vocode else (0, 0)
        return PendingSynthesis(out=out, cleaned=cleaned, b=b, t0=t0, clock=clock, done=done,
                                frontend_s=frontend_s, host_read_s=host_read_s, live=live,
                                k1_frames_live=live_frames, k1_frames_all=all_frames)

    def _mel_bucket(self, y_lengths: torch.Tensor, group=None) -> tuple[int, float, Optional[np.ndarray]]:
        """The two-stage host read: the rows' predicted mel lengths come back
        in one sync, and the longest (over a mesh's data axis too) picks the
        mel bucket → (bucket, seconds the read took, the rows' lengths, or
        None over a data axis, where only the longest is read).  On one CUDA
        stream the read returns when everything enqueued before it has
        finished."""
        t0 = time.perf_counter()
        with obs.span("pipeline.host_read"):
            lengths = None
            if group is None:
                lengths = y_lengths.cpu().numpy()
                longest = int(lengths.max())
            else:
                y_len_max = y_lengths.max()
                collectives["all_reduce"] += 1
                torch.distributed.all_reduce(y_len_max, op=torch.distributed.ReduceOp.MAX, group=group)
                longest = int(y_len_max.item())
            m_bucket = pick_bucket(fix_len_compatibility(longest), self.mel_buckets)
        return m_bucket, time.perf_counter() - t0, lengths

    def _staged(self, x_np, xl_np, spks, seed, n_timesteps, temperature, length_scale, denoiser_strength, fused,
                fused_mel_bucket, keep_mel, vocode, pcm16, live):
        """``synthesise_async``'s work through the graph store, one graph per
        stage: encoder + durations, CFM decode, vocoder (by reach: rows from
        `live` on are pad rows), denoiser + pcm16; called under the store's
        lock → (host outputs, the CUDA event after their copies, clock,
        seconds of the host read, ``_k1_frames``).  The keys
        carry what the JAX pipeline's keys carry (``_get_stage_a`` /
        ``_get_stage_b`` / ``_get_fused``) and changes a program here: the
        buckets, the batch, the step count, the dtypes, denoise and pcm16;
        `length_scale`, `denoiser_strength`, the noise (with the temperature
        in it) and the speakers are runtime inputs.  ``keep_mel`` and
        ``vocode`` pick which outputs are copied out and whether the vocoder's
        graphs run, not a program."""
        g = self.graphs
        b, t_bucket = x_np.shape
        clock = StageClock(self.device)
        with obs.span("pipeline.stage_a"):
            x = upload(torch.from_numpy(x_np), self.device)
            x_lengths = upload(torch.from_numpy(xl_np), self.device)
            spk = self._speakers(spks, b)
            # fused, the encoder runs in the compute dtype; two-stage, stage A stays f32 (the JAX stage A casts nothing)
            model = self.compute_model if fused else self.model
            enc_key = ("encoder", t_bucket, b, spk is not None, self.compute_dtype if fused else torch.float32)
            enc = g.run(enc_key, model.encode_text, (x, x_lengths, spk, float(length_scale)), weights=(model,))
            clock.mark("encoder")
        host_read_s, lengths = 0.0, None
        if fused:
            m_bucket = fused_mel_bucket or self.mel_buckets[-1]
        else:
            m_bucket, host_read_s, lengths = self._mel_bucket(enc[2])
        with obs.span("pipeline.launch"):
            z = synthesis_noise(seed, b, m_bucket, self.model_cfg.n_feats, temperature, self.device)  # f32
            mel, mel_lengths = g.run(("decoder", t_bucket, m_bucket, b, n_timesteps, self.compute_dtype),
                                     self._decode_fn(m_bucket, n_timesteps), (*enc, z), weights=(self.compute_model,))
            clock.mark("decoder")
            out = {"mel_lengths": mel_lengths}
            if keep_mel:
                out["mel"] = mel.float()
            if vocode:
                out["wav"] = self._vocode_denoise_pcm(mel, denoiser_strength > 0, denoiser_strength, pcm16, clock,
                                                      self._served(mel_lengths, live))
            out, done = to_host_async(out)
        return out, done, clock, host_read_s, self._k1_frames(lengths, live, m_bucket, True) if vocode else (0, 0)

    def _decode_fn(self, m_bucket: int, n_timesteps: int):
        """Stage B's decode on stage A's outputs, cast to the compute dtype
        first (as the JAX stage B casts; a no-op on the fused path's) →
        (mel, mel_lengths)."""
        dt = self.compute_dtype

        def decode(mu_x, w_ceil, y_lengths, x_mask, spk_e, z):
            spk_e = spk_e.to(dt) if spk_e is not None else None
            dec = self.compute_model.decode_mel(mu_x.to(dt), w_ceil, y_lengths, x_mask.to(dt), spk_e, m_bucket,
                                                n_timesteps, z)
            return dec["mel"], dec["mel_lengths"]
        return decode

    def finalize(self, p: PendingSynthesis) -> list[SynthesisResult]:
        """Wait for an enqueued batch's host copies and build the results of
        its live rows.  The RTF clock spans enqueue → copy of this batch."""
        if p.done is not None:
            p.done.synchronize()  # this batch's copies only, not the stream's later work
        out = {k: v.numpy() for k, v in p.out.items()}
        t_total = time.perf_counter() - p.t0
        stage_ms = p.clock.elapsed_ms()
        results = []
        for i in range(p.b if p.live is None else p.live):
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
        """Run one short request with the serving flags: through graphs,
        this captures the keys it hits, as the reference's warmup compiles
        them; eagerly, first-call allocations, cuFFT plans and the kernel
        build happen here."""
        self.synthesise(["a " * 10] * batch, spks=[0] * batch if self.model_cfg.n_spks > 1 else None,
                        n_timesteps=n_timesteps, seed=0, fused=fused, keep_mel=keep_mel, vocode=vocode,
                        pcm16=pcm16)
