"""Exported synthesis programs and the bundle runner (PyTorch port of
``emojivoice_tpu.inference.export``).

``torch.export`` traces the fused synthesis chain (encoder + durations,
alignment, the Euler CFM decode at a static mel bucket, HiFi-GAN, the
denoiser, optional pcm16) with its weights into one program per
(batch, text bucket, mel bucket), and the duration head alone into one per
(batch, text bucket), which the runner uses to choose the mel bucket.  Each
is ``<name>.pt2`` (``torch.export.save``) with ``<name>.json`` beside it; a
bundle is a directory of them with a ``manifest.json``.  Like the JAX
bundle, it fixes the step count, the denoiser strength and pcm16 at export.

Program signatures (B, the text bucket T and the mel bucket M are static):

* synthesis: ``(x (B, T) int64, x_lengths (B,) int64, spks (B,) int64,
  length_scale () f32, temperature () f32, z (B, M, n_feats) f32)`` →
  ``(wav (B, M·upsample) f32, or int16 with pcm16 | mel (B, M, n_feats),
  mel_lengths (B,) int32)``;
* durations: ``(x, x_lengths, spks, length_scale)`` → ``y_lengths (B,) int32``.

Noise lies outside the graph (a seeded ``torch.Generator`` cannot live in an
exported program): z is unscaled and the program multiplies it by the
temperature.  The runner draws row i's z with ``utils/prng.synthesis_noise``
from that row's seed, so a bundle row with seed s is the live pipeline's
fused per-row-seed row with seed s at the same mel bucket, to the bit.  An
int seed gives row i the stream of seed + i, as in the JAX runner.

A program runs on the device it was exported on: a bundle made on the card
refuses the CPU and the other way round.  On the card its vocoder runs K1:
each MRF stage is one node of the registered op
``emojivoice_tpu_torch::mrf_stage`` (``ops/mrf.py``), whose operands, packed
for the kernel before export, the program carries as buffers in place of the
res-block convs.  Programs are called under ``torch.inference_mode()``.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from emojivoice_tpu_torch import text as textlib
from emojivoice_tpu_torch.inference.pipeline import (HOP_LENGTH, SAMPLE_RATE, SynthesisResult, to_host_async,
                                                     upload)
from emojivoice_tpu_torch.ops import mrf  # noqa: F401  registers emojivoice_tpu_torch::mrf_stage, which programs call
from emojivoice_tpu_torch.utils.masks import fix_len_compatibility, intersperse
from emojivoice_tpu_torch.utils.prng import synthesis_noise
from emojivoice_tpu_torch.vocoder.denoiser import denoise

FORMAT = "emojivoice-torch-export-bundle-v1"


class _SynthesisProgram(nn.Module):
    """The fused chain at one mel bucket, as ``torch.export`` traces it."""

    def __init__(self, pipeline, mel_bucket: int, n_timesteps: int, with_vocoder: bool,
                 denoiser_strength: float, pcm16: bool):
        super().__init__()
        self.model = pipeline.model
        self.mel_bucket, self.n_timesteps, self.pcm16 = mel_bucket, n_timesteps, pcm16
        self.use_spks = pipeline.model_cfg.n_spks > 1
        self.vocoder, self.strength = None, 0.0
        if not with_vocoder:
            return
        # on the card each MRF stage is one node of the registered op, K1's operands packed here as buffers
        self.vocoder = pipeline.vocoder.for_export()
        if denoiser_strength > 0:
            self.strength = float(denoiser_strength)
            self.register_buffer("bias_spec", pipeline.denoiser.bias_spec)

    def forward(self, x, x_lengths, spks, length_scale, temperature, z):
        out = self.model.synthesise(x, x_lengths, self.mel_bucket, self.n_timesteps, z * temperature,
                                    spks if self.use_spks else None, length_scale)
        if self.vocoder is None:
            return out["mel"], out["mel_lengths"]
        wav = self.vocoder(out["mel"])
        if self.strength > 0:
            wav = denoise(wav, self.bias_spec, self.strength)
        if self.pcm16:
            wav = (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
        return wav, out["mel_lengths"]


class _DurationProgram(nn.Module):
    def __init__(self, pipeline):
        super().__init__()
        self.model = pipeline.model
        self.use_spks = pipeline.model_cfg.n_spks > 1

    def forward(self, x, x_lengths, spks, length_scale):
        return self.model.encode_text(x, x_lengths, spks if self.use_spks else None, length_scale)[2]


def _example_inputs(pipeline, batch: int, text_bucket: int) -> tuple:
    dev = pipeline.device
    return (torch.zeros((batch, text_bucket), dtype=torch.int64, device=dev),
            torch.ones((batch,), dtype=torch.int64, device=dev),
            torch.zeros((batch,), dtype=torch.int64, device=dev),
            torch.ones((), dtype=torch.float32, device=dev))


def _export(program: nn.Module, args: tuple, path: str, meta: dict) -> Path:
    with torch.no_grad():
        # one eager run first: the tables the model keeps per shape (RoPE's) then enter the program as constants
        # on its device, not as host tensors copied up, and waited for, on every run
        program.eval()(*args)
        exported = torch.export.export(program, args, strict=False)
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, out.with_suffix(".pt2"))
    out.with_suffix(".json").write_text(json.dumps(meta, indent=2))
    return out.with_suffix(".pt2")


def export_synthesis(pipeline, path: str, text_bucket: int = 256, mel_bucket: int = 512, n_timesteps: int = 10,
                     with_vocoder: bool = True, denoiser_strength: float = 0.00025, batch: int = 1,
                     pcm16: bool = False) -> Path:
    """Export the fused text → wav (or mel) program with the weights in it;
    see the module docstring for its signature.  A pipeline without a vocoder
    exports mel programs whatever `with_vocoder` says."""
    with_vocoder = with_vocoder and pipeline.vocoder is not None
    program = _SynthesisProgram(pipeline, mel_bucket, n_timesteps, with_vocoder, denoiser_strength,
                                pcm16 and with_vocoder)
    args = (*_example_inputs(pipeline, batch, text_bucket), torch.ones((), device=pipeline.device),
            torch.zeros((batch, mel_bucket, pipeline.model_cfg.n_feats), device=pipeline.device))
    meta = {
        "batch": batch, "text_bucket": text_bucket, "mel_bucket": mel_bucket, "n_timesteps": n_timesteps,
        "with_vocoder": with_vocoder, "denoiser_strength": denoiser_strength, "n_spks": pipeline.model_cfg.n_spks,
        "n_feats": pipeline.model_cfg.n_feats,
        "upsample": pipeline.vocoder_cfg.total_upsample if with_vocoder else None,
        "device": pipeline.device.type, "pcm16": bool(pcm16 and with_vocoder), "rng_per_row": True,
    }
    return _export(program, args, path, meta)


def export_durations(pipeline, path: str, text_bucket: int, batch: int = 1) -> Path:
    """Export the duration program, (x, x_lengths, spks, length_scale) →
    y_lengths: the runner reads it on the host to choose the mel bucket, the
    explicit form of the two-stage pipeline's one host read."""
    meta = {"batch": batch, "text_bucket": text_bucket, "device": pipeline.device.type}
    return _export(_DurationProgram(pipeline), _example_inputs(pipeline, batch, text_bucket), path, meta)


def export_bundle(pipeline, out_dir: str, text_buckets: Optional[list] = None, mel_buckets: Optional[list] = None,
                  batches: tuple = (1, 8), n_timesteps: int = 10, with_vocoder: bool = True,
                  denoiser_strength: float = 0.00025, pcm16: bool = False) -> Path:
    """Export programs over (batch × text bucket × mel bucket) and a duration
    program per (batch, text bucket), on the pipeline's device, and write the
    manifest.  Returns the manifest's path."""
    text_buckets = sorted(text_buckets or pipeline.text_buckets)
    mel_buckets = sorted(mel_buckets or pipeline.mel_buckets)
    batches = tuple(sorted(set(int(b) for b in batches)))
    with_vocoder = with_vocoder and pipeline.vocoder is not None
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    programs = []
    for b in batches:
        for t in text_buckets:
            dur_name = f"dur_b{b}_t{t}"
            export_durations(pipeline, str(out / dur_name), t, batch=b)
            for m in mel_buckets:
                name = f"synth_b{b}_t{t}_m{m}"
                export_synthesis(pipeline, str(out / name), text_bucket=t, mel_bucket=m, n_timesteps=n_timesteps,
                                 with_vocoder=with_vocoder, denoiser_strength=denoiser_strength, batch=b,
                                 pcm16=pcm16)
                programs.append({"batch": b, "text_bucket": t, "mel_bucket": m, "synth": name,
                                 "durations": dur_name})
    manifest = {
        "format": FORMAT,
        "device": pipeline.device.type,
        "batches": list(batches),
        "text_buckets": list(text_buckets),
        "mel_buckets": list(mel_buckets),
        "n_timesteps": n_timesteps,
        "with_vocoder": with_vocoder,
        "denoiser_strength": denoiser_strength,
        "n_spks": pipeline.model_cfg.n_spks,
        "n_feats": pipeline.model_cfg.n_feats,
        "sample_rate": SAMPLE_RATE,
        "hop_length": HOP_LENGTH,
        "upsample": pipeline.vocoder_cfg.total_upsample if with_vocoder else None,
        "pcm16": bool(pcm16 and with_vocoder),
        "rng_per_row": True,
        "cleaners": list(pipeline.cleaners),
        "programs": programs,
    }
    manifest_path = out / "manifest.json"
    manifest_path.write_text(json.dumps(manifest, indent=2))
    return manifest_path


def _serving_device(exported_on: str, device, what: str) -> torch.device:
    """The device to run programs exported on `exported_on`: `device`, which
    must be that same kind and, for the card, present."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f'{what}: no CUDA device is available (a bundle exported with --cpu runs with '
                           f'device="cpu" / --cpu)')
    if device.type != exported_on:
        raise ValueError(f"{what}: exported on {exported_on}, asked to run on {device.type}; a program runs on "
                         f"the device it was exported on (export {'with' if device.type == 'cpu' else 'without'} "
                         f"--cpu for this one)")
    return device


def _row_seeds(seed, n: int) -> list:
    """An int seed gives row i the stream of seed + i; a sequence pins each row's."""
    seeds = [int(seed) + i for i in range(n)] if isinstance(seed, (int, np.integer)) else [int(s) for s in seed]
    if len(seeds) != n:
        raise ValueError(f"got {len(seeds)} seeds for {n} texts")
    return seeds


def _load_program(path: Path):
    return torch.export.load(path).module()


class ExportedSynthesizer:
    """Run one exported synthesis program on padded inputs."""

    def __init__(self, path: str, device="cuda"):
        p = Path(path)
        self.meta = json.loads(p.with_suffix(".json").read_text())
        self.device = _serving_device(self.meta["device"], device, str(p))
        self.program = _load_program(p.with_suffix(".pt2"))

    @torch.inference_mode()
    def __call__(self, x, x_lengths, spks, length_scale=1.0, temperature=0.667, seed=0):
        b = self.meta["batch"]
        z = synthesis_noise(_row_seeds(seed, b), b, self.meta["mel_bucket"], self.meta["n_feats"], 1.0, self.device)
        out, mel_lengths = self.program(
            *(upload(torch.as_tensor(np.asarray(a), dtype=torch.int64), self.device) for a in (x, x_lengths, spks)),
            *(upload(torch.tensor(v, dtype=torch.float32), self.device) for v in (length_scale, temperature)), z)
        return out.cpu().numpy(), mel_lengths.cpu().numpy()


class LoadedBundle:
    """Run an exported bundle end to end: load programs lazily, pad inputs to
    the bucket grid, pick the (batch, text, mel) program through the duration
    program, and return trimmed per-utterance results."""

    def __init__(self, bundle_dir: str, device="cuda"):
        self.dir = Path(bundle_dir)
        self.meta = json.loads((self.dir / "manifest.json").read_text())
        if self.meta.get("format") != FORMAT:
            raise ValueError(f"{bundle_dir}: format {self.meta.get('format')!r} is not the PyTorch port's "
                             f"export bundle ({FORMAT!r}); export one with emojivoice-export-bundle-torch")
        self.device = _serving_device(self.meta["device"], device, str(bundle_dir))
        self._cache: dict = {}
        self._lock = threading.Lock()  # serving threads load programs lazily

    def _load(self, name: str):
        with self._lock:
            if name not in self._cache:
                self._cache[name] = _load_program(self.dir / f"{name}.pt2")
            return self._cache[name]

    @staticmethod
    def _pick(value: int, buckets, what: str) -> int:
        for b in sorted(buckets):
            if b >= value:
                return b
        raise ValueError(f"{what} {value} exceeds largest exported bucket {max(buckets)}")

    def encode_texts(self, texts, language=None):
        """Clean + encode with the bundle's exported cleaners (or a per-call
        ``language``) → (interspersed id lists, cleaned texts)."""
        cleaners = tuple(self.meta["cleaners"])
        if language is not None:
            from emojivoice_tpu_torch.text.cleaners import LANGUAGE_CLEANERS

            cleaners = (LANGUAGE_CLEANERS[language].__name__,)
        seqs, cleaned = [], []
        for t in texts:
            ids, cl = textlib.text_to_sequence(t, cleaners)
            seqs.append(intersperse(ids, 0))
            cleaned.append(cl)
        return seqs, cleaned

    def synthesise(self, texts, spks=None, length_scale: float = 1.0, temperature: float = 0.667, seed=0,
                   language=None, mel_bucket: Optional[int] = None):
        """Returns (results, timings): results are dicts with wav (or mel),
        mel_length and cleaned_text; timings {"wall_s", "rtf", ...} over the
        padded batch.  More texts than the largest exported batch are served
        in chunks of it.  A bundle with one mel bucket, or a pinned
        ``mel_bucket``, skips the duration program."""
        max_batch = max(self.meta["batches"])
        if len(texts) > max_batch:
            all_results, walls, audio = [], 0.0, 0.0
            for i in range(0, len(texts), max_batch):
                chunk_seed = seed + i if isinstance(seed, (int, np.integer)) else list(seed)[i:i + max_batch]
                res, t = self.synthesise(texts[i:i + max_batch],
                                         spks=spks[i:i + max_batch] if spks is not None else None,
                                         length_scale=length_scale, temperature=temperature, seed=chunk_seed,
                                         language=language, mel_bucket=mel_bucket)
                all_results.extend(res)
                walls += t["wall_s"]
                audio += t["wall_s"] / t["rtf"] if t["rtf"] else 0.0
            timings = {"wall_s": walls, "rtf": walls / audio if audio else float("inf"), "batch": max_batch,
                       "chunks": -(-len(texts) // max_batch)}
            return all_results, timings
        return self.fetch(self.dispatch(texts, spks=spks, length_scale=length_scale, temperature=temperature,
                                        seed=seed, language=language, mel_bucket=mel_bucket))

    @torch.inference_mode()
    def dispatch(self, texts, spks=None, length_scale: float = 1.0, temperature: float = 0.667, seed=0,
                 language=None, mel_bucket: Optional[int] = None) -> dict:
        """Enqueue one padded-batch program, then the copies of its outputs
        into pinned host memory and an event, without waiting (the duration
        program's host read aside).  Returns the record ``fetch`` takes;
        ``len(texts)`` must fit the largest exported batch."""
        meta = self.meta
        t0 = time.perf_counter()
        seqs, cleaned = self.encode_texts(texts, language=language)
        n = len(seqs)
        batch = self._pick(n, meta["batches"], "batch")
        t_bucket = self._pick(max(len(s) for s in seqs), meta["text_buckets"], "text length")
        x = np.zeros((batch, t_bucket), np.int64)
        xl = np.zeros((batch,), np.int64)
        spk = np.zeros((batch,), np.int64)
        for i in range(batch):
            s = seqs[min(i, n - 1)]  # pad rows repeat the last text
            x[i, :len(s)] = s
            xl[i] = len(s)
            if spks is not None:
                spk[i] = int(spks[min(i, n - 1)])
        spk = np.clip(spk, 0, meta["n_spks"] - 1)  # out-of-range ids clamped, as the live pipeline does
        row_seeds = _row_seeds(seed, n)
        row_seeds += [row_seeds[-1]] * (batch - n)  # pad rows, trimmed anyway
        args = [upload(torch.from_numpy(a), self.device) for a in (x, xl, spk)]
        args.append(upload(torch.tensor(length_scale, dtype=torch.float32), self.device))

        if mel_bucket is not None:
            if mel_bucket not in meta["mel_buckets"]:
                raise ValueError(f"mel_bucket {mel_bucket} not in exported grid {meta['mel_buckets']}")
            m_bucket = int(mel_bucket)
        elif len(meta["mel_buckets"]) == 1:
            m_bucket = int(meta["mel_buckets"][0])
        else:
            y_lengths = self._load(f"dur_b{batch}_t{t_bucket}")(*args)
            # the host read: the predicted mel length picks the mel bucket
            m_bucket = self._pick(fix_len_compatibility(int(y_lengths.max())), meta["mel_buckets"], "mel length")

        prog = self._load(f"synth_b{batch}_t{t_bucket}_m{m_bucket}")
        z = synthesis_noise(row_seeds, batch, m_bucket, meta["n_feats"], 1.0, self.device)
        temp = upload(torch.tensor(temperature, dtype=torch.float32), self.device)
        out, mel_lengths = prog(*args, temp, z)
        host, done = to_host_async({"out": out, "mel_lengths": mel_lengths})
        return {"out": host, "done": done, "n": n, "batch": batch, "t_bucket": t_bucket, "m_bucket": m_bucket,
                "t0": t0, "cleaned": cleaned, "pinned": mel_bucket is not None,
                # replayed if a pinned bucket saturates
                "args": dict(texts=texts, spks=spks, length_scale=length_scale, temperature=temperature, seed=seed,
                             language=language)}

    def fetch(self, p: dict):
        """Wait for a dispatched batch's host copies (its event only) and
        build the trimmed results.  A pinned mel bucket that the predicted
        lengths saturate, in a bundle with a larger one, is served again
        through the duration program's pick; the wall clock keeps the first
        attempt's start."""
        if p["done"] is not None:
            p["done"].synchronize()
        out = p["out"]["out"].numpy()
        mel_lengths = p["out"]["mel_lengths"].numpy().astype(int)
        n, m_bucket, meta = p["n"], p["m_bucket"], self.meta
        if p["pinned"] and mel_lengths.max() >= m_bucket and m_bucket < max(meta["mel_buckets"]):
            replay = self.dispatch(**p["args"])
            replay["t0"] = p["t0"]
            return self.fetch(replay)
        wall = time.perf_counter() - p["t0"]
        ups = meta["upsample"] or meta["hop_length"]
        results = []
        for i in range(n):  # pad rows trimmed
            ml = int(mel_lengths[i])
            if meta["with_vocoder"]:
                # pcm16 bundles return int16 samples, f32 bundles floats: the dtype says which
                results.append({"wav": out[i, :ml * ups], "mel_length": ml, "cleaned_text": p["cleaned"][i]})
            else:
                results.append({"mel": out[i, :ml], "mel_length": ml, "cleaned_text": p["cleaned"][i]})
        audio_s = float(mel_lengths[:n].sum()) * meta["hop_length"] / meta["sample_rate"]
        timings = {"wall_s": wall, "rtf": wall / audio_s if audio_s else float("inf"), "batch": p["batch"], "n": n,
                   "text_bucket": p["t_bucket"], "mel_bucket": m_bucket}
        return results, timings


class BundleSynthesisPipeline:
    """The serving engine's and webapp's pipeline surface over an exported
    bundle: ``synthesise_async`` / ``finalize``, ``synthesise`` and
    ``warmup``.  Per-request seeds work as on the live pipeline.

    Fixed per bundle: the step count and the denoiser strength (a request
    asking for others is refused: export a bundle per operating point), the
    pcm16 wire format (a request's ``pcm16`` is advisory; results always hold
    float32 wav), and no mel (``keep_mel`` requests get an empty one)."""

    def __init__(self, bundle, language: Optional[str] = None, device="cuda"):
        self.bundle = bundle if isinstance(bundle, LoadedBundle) else LoadedBundle(bundle, device=device)
        meta = self.bundle.meta
        if not meta.get("with_vocoder"):
            # a --no_vocoder bundle carries mels only; serving it would hand every client empty audio
            raise ValueError("bundle was exported with --no_vocoder (mel-only); serving needs waveform programs: "
                             "export again without --no_vocoder")
        if language is not None:
            from emojivoice_tpu_torch.text.cleaners import LANGUAGE_CLEANERS

            if language not in LANGUAGE_CLEANERS:
                raise KeyError(f"Unknown language {language!r}; available: {sorted(LANGUAGE_CLEANERS)}")
        self.language = language  # None: the bundle's exported cleaners
        self.batch_buckets = tuple(meta["batches"])
        self.n_timesteps = int(meta["n_timesteps"])
        self.denoiser_strength = float(meta["denoiser_strength"])

    def _check(self, n_timesteps: int, denoiser_strength: float) -> None:
        if int(n_timesteps) != self.n_timesteps:
            raise ValueError(f"bundle is exported at n_timesteps={self.n_timesteps}, got {n_timesteps} "
                             f"(export a bundle per operating point)")
        if abs(float(denoiser_strength) - self.denoiser_strength) > 1e-9:
            raise ValueError(f"bundle is exported at denoiser_strength={self.denoiser_strength}, "
                             f"got {denoiser_strength}")

    def synthesise_async(self, texts, spks=None, n_timesteps: Optional[int] = None, temperature: float = 0.667,
                         length_scale: float = 1.0, denoiser_strength=None, language=None, seed=None,
                         keep_mel: bool = True, vocode: bool = True, pcm16: bool = False):
        self._check(self.n_timesteps if n_timesteps is None else n_timesteps,
                    self.denoiser_strength if denoiser_strength is None else denoiser_strength)
        if seed is None:
            seed = int(np.random.randint(0, 2**31))
        return self.bundle.dispatch(texts, spks=spks, length_scale=length_scale, temperature=temperature, seed=seed,
                                    language=language if language is not None else self.language)

    def finalize(self, pending) -> list:
        results, timings = self.bundle.fetch(pending)
        b = max(timings["n"], 1)  # amortized over the real rows, as the live finalize does
        out = []
        for r in results:
            wav = r["wav"]
            wav = wav.astype(np.float32) / 32767.0 if wav.dtype == np.int16 else wav.astype(np.float32)
            ml = r["mel_length"]
            # reference RTF formulas (cli.py:301-302), amortized per row like the live finalize
            rtf = timings["wall_s"] * SAMPLE_RATE / (max(ml, 1) * HOP_LENGTH) / b
            rtf_w = timings["wall_s"] * SAMPLE_RATE / max(len(wav), 1) / b if len(wav) else float("nan")
            out.append(SynthesisResult(wav=wav, mel=np.zeros((0, 0), np.float32), mel_length=ml, rtf=rtf,
                                       rtf_w=rtf_w, cleaned_text=r["cleaned_text"]))
        return out

    def synthesise(self, texts, **kw) -> list:
        return self.finalize(self.synthesise_async(texts, **kw))

    @torch.inference_mode()
    def warmup(self, n_timesteps: Optional[int] = None, batch: int = 1, **_ignored) -> None:
        """Load and run every program of this batch bucket once, off the
        request path.  ``n_timesteps=None`` means the bundle's own."""
        self._check(self.n_timesteps if n_timesteps is None else n_timesteps, self.denoiser_strength)
        meta, dev = self.bundle.meta, self.bundle.device
        if batch not in meta["batches"]:
            raise ValueError(f"batch {batch} not in exported grid {meta['batches']}")
        for t in meta["text_buckets"]:
            x = torch.zeros((batch, t), dtype=torch.int64, device=dev)
            x[:, 0] = 50
            args = (x, torch.ones((batch,), dtype=torch.int64, device=dev),
                    torch.zeros((batch,), dtype=torch.int64, device=dev), torch.ones((), device=dev))
            if len(meta["mel_buckets"]) > 1:
                self.bundle._load(f"dur_b{batch}_t{t}")(*args).cpu()
            for m in meta["mel_buckets"]:
                z = synthesis_noise(list(range(batch)), batch, m, meta["n_feats"], 1.0, dev)
                self.bundle._load(f"synth_b{batch}_t{t}_m{m}")(*args, torch.full((), 0.667, device=dev), z)[1].cpu()


# ---------------------------------------------------------------------------
# CLIs: emojivoice-export-bundle-torch / emojivoice-run-exported-torch
# ---------------------------------------------------------------------------

def main_export(argv=None) -> int:
    """Export a checkpoint (or a random init) to a bundle, on the device it
    will serve on: the card unless ``--cpu``."""
    p = argparse.ArgumentParser(prog="emojivoice-export-bundle-torch")
    p.add_argument("--checkpoint_path", default=None, help="MatchaTTS .ckpt (reference format)")
    p.add_argument("--vocoder", default=None, help="HiFi-GAN generator dump")
    p.add_argument("--ckpt_dir", default=None, help="alternatively: the ckpts/ of emojivoice-train-torch")
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--text_buckets", type=int, nargs="+", default=None)
    p.add_argument("--mel_buckets", type=int, nargs="+", default=None)
    p.add_argument("--batches", type=int, nargs="+", default=[1, 8])
    p.add_argument("--no_vocoder", action="store_true")
    p.add_argument("--pcm16", action="store_true", help="quantize wav to int16 on the device (halves the copy)")
    p.add_argument("--denoiser_strength", type=float, default=0.00025)
    p.add_argument("--cpu", action="store_true", help="export for the CPU instead of the CUDA device")
    args = p.parse_args(argv)

    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline

    device = "cpu" if args.cpu else "cuda"
    if args.random_init:
        pipe = SynthesisPipeline.from_random(device=device)
    elif args.ckpt_dir:
        pipe = SynthesisPipeline.from_checkpoint(args.ckpt_dir, vocoder_ckpt=args.vocoder, device=device)
    elif args.checkpoint_path:
        pipe = SynthesisPipeline.from_torch_checkpoints(args.checkpoint_path, args.vocoder, device=device)
    else:
        p.error("one of --checkpoint_path / --ckpt_dir / --random_init is required")
    manifest = export_bundle(pipe, args.output_dir, text_buckets=args.text_buckets, mel_buckets=args.mel_buckets,
                             batches=tuple(args.batches), n_timesteps=args.steps, with_vocoder=not args.no_vocoder,
                             denoiser_strength=args.denoiser_strength, pcm16=args.pcm16)
    meta = json.loads(manifest.read_text())
    print(f"wrote bundle: {manifest.parent} ({len(meta['programs'])} programs on {meta['device']}, "
          f"batches={meta['batches']} text={meta['text_buckets']} mel={meta['mel_buckets']})")
    return 0


def main_run(argv=None) -> int:
    """Run a bundle: pad, pick programs, write wavs (mels with a
    ``--no_vocoder`` bundle), report RTF."""
    p = argparse.ArgumentParser(prog="emojivoice-run-exported-torch")
    p.add_argument("--bundle", required=True)
    p.add_argument("--text", default=None)
    p.add_argument("--file", default=None, help="lines of 'text' or 'text|spk'")
    p.add_argument("--spk", type=int, default=0)
    p.add_argument("--language", default=None)
    p.add_argument("--temperature", type=float, default=0.667)
    p.add_argument("--speaking_rate", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mel_bucket", type=int, default=None,
                   help="pin an exported mel bucket to skip the duration program (escalates if it saturates)")
    p.add_argument("--output_folder", default="exported_out")
    p.add_argument("--cpu", action="store_true", help="run a bundle exported with --cpu")
    args = p.parse_args(argv)
    if not args.text and not args.file:
        p.error("--text or --file required")
    if args.file:
        texts, spks = [], []
        for line in (ln.strip() for ln in Path(args.file).read_text().splitlines()):
            if not line:
                continue
            text, sep, spk = line.rpartition("|")
            texts.append(text if sep else spk)
            spks.append(int(spk) if sep else args.spk)
    else:
        texts, spks = [args.text], [args.spk]

    bundle = LoadedBundle(args.bundle, device="cpu" if args.cpu else "cuda")
    # the reference passes speaking_rate straight through as length_scale, as the live CLI does
    results, timings = bundle.synthesise(texts, spks=spks, length_scale=args.speaking_rate,
                                         temperature=args.temperature, seed=args.seed, language=args.language,
                                         mel_bucket=args.mel_bucket)
    out_dir = Path(args.output_folder)
    out_dir.mkdir(parents=True, exist_ok=True)
    sr = bundle.meta["sample_rate"]
    for i, res in enumerate(results):
        if "wav" not in res:
            np.save(out_dir / f"utterance_{i + 1:03d}_mel.npy", res["mel"])
        elif res["wav"].dtype == np.int16:  # a pcm16 bundle: the samples are written as they are
            from scipy.io import wavfile

            wavfile.write(out_dir / f"utterance_{i + 1:03d}.wav", sr, res["wav"])
        else:
            from emojivoice_tpu_torch.inference.cli import save_wav

            save_wav(str(out_dir / f"utterance_{i + 1:03d}.wav"), res["wav"], sr)
    print(json.dumps({"n": len(results), **timings, "output_folder": str(out_dir)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main_export())
