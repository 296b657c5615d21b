"""Model FLOPs utilisation of the hot programs on the card (twin of ``tools/mfu.py``).

    python -m emojivoice_tpu_torch.bench.mfu [--skip_sweep] [--skip_train] [--skip_stages]

The twin's three sections, on emoji_multi + HiFi-GAN v1 (random weights, seed
0), 10 Euler steps, the bench's headline text at batch 1:

1. ``programs``: the fused synthesis call, a training step (batch
   ``--train_batch``, 96 text × 384 mel frames, ``out_size`` 172) and the
   HiFi-GAN generator alone at 1 × ``--voc_frames``;
2. ``stages``: the fused call cut at its seams (encoder with durations; the
   alignment expansion and the Euler decode; HiFi-GAN through K1; the
   denoiser), each run on its own, and their sum beside the fused call;
3. ``precision_sweep``: the fused and two-stage calls under the precision
   switches (``vocoder_dtype`` / ``compute_dtype`` bf16).

**FLOPs and bytes are the port's own count, worked out from shapes** (there
is no XLA cost model here, and ``torch.utils.flop_counter`` sees neither
K1, a launch of its own, nor all of the plain path's convs).  FLOPs are
products, two per multiply-add: every ``nn.Conv1d``, ``nn.ConvTranspose1d``
and ``nn.Linear`` the call runs (read by forward hooks from the shapes they
see), the attention's two products per head, the time MLP, the alignment
expansion (and in training the log-prior), HiFi-GAN from its config (each
MRF stage 2·k·C² per output per conv: 252·B·T·C² for v1's three res-blocks),
the denoiser's two FFTs at 5·N·log2 N / 2 per real frame.  A training step
counts 3 × its forward.  Elementwise work is not counted: HiFi-GAN v1 at
1 × 512 frames counts 314.4 GFLOP against the 317.7 that XLA's cost model gave
the JAX generator (``docs/artifacts/mfu.json``, ``hifigan_b1_t512``).  Bytes
are each counted layer's input, weights and output once (eager traffic
without fusion), HiFi-GAN's the mel, its weights and the waveform.

Time is device ms (the summed device activity of one profiled call, the
median of three) and wall ms (a synchronised call, the median of ``--repeats``; every wall is taken
before the first profiled call: after its first ``torch.profiler`` session a
process's calls ran slower on the card); MFU
is given over both.  The peak follows the precision that ran: f32 products
with TF32 off at 67 TFLOP/s, K1's 3xTF32 products as three TF32 products at
495 (so 165 for its f32 work), bf16 at 989; a program mixing them is held to
the time each part would take at its own peak (``peak_tflops`` is the rate
that makes the sum), memory at 3.35 TB/s.

Key names mapped from the twin: ``peak_bf16_tflops`` → ``peak_tflops``
(with ``peak_of``, the precisions it combines), ``pct_of_bf16_peak`` →
``pct_of_peak`` (over device time) and ``pct_of_peak_wall``;
``device_ms_per_call`` is the profiled device time; the twin's
``flops_xla_equiv`` / ``*_true`` fields, which corrected XLA's blindness to
Pallas calls, have no counterpart: this count sees K1's work.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import statistics

import numpy as np
import torch
from torch import nn

from emojivoice_tpu_torch.bench import util

# peak rate of each kind of product on one H100 (NVIDIA's data sheet, dense)
PEAKS = {"f32": util.F32_FLOPS, "k1_3xtf32": util.TF32_FLOPS / 3, "bf16": util.BF16_FLOPS}


# ---------------------------------------------------------------------- #
# the count
# ---------------------------------------------------------------------- #

class Count:
    """FLOPs by kind of product and bytes, summed over a call."""

    def __init__(self):
        self.flops: dict = {}
        self.bytes = 0.0

    def add(self, flops: float, nbytes: float = 0.0, kind: str = "f32") -> "Count":
        self.flops[kind] = self.flops.get(kind, 0.0) + float(flops)
        self.bytes += float(nbytes)
        return self

    def __iadd__(self, other: "Count") -> "Count":
        for k, v in other.flops.items():
            self.add(v, 0.0, k)
        self.bytes += other.bytes
        return self

    def scaled(self, factor: float) -> "Count":
        out = Count()
        out.flops = {k: v * factor for k, v in self.flops.items()}
        out.bytes = self.bytes * factor
        return out

    @property
    def total(self) -> float:
        return sum(self.flops.values())

    def bound_s(self) -> float:
        """Least time at each kind's peak (the larger of that and bytes over the memory rate)."""
        return max(sum(v / PEAKS[k] for k, v in self.flops.items()), self.bytes / util.HBM_BYTES_PER_S)


def _nbytes(*ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts if isinstance(t, torch.Tensor)))


def _kind(t: torch.Tensor) -> str:
    return "bf16" if t.dtype in (torch.bfloat16, torch.float16) else "f32"


def _layer_count(module: nn.Module, inputs: tuple, output) -> Count | None:
    """The products of one layer's call, from the shapes it saw; None for a
    module that is not counted itself (its children are)."""
    from emojivoice_tpu_torch.models.decoder import Attention, TimestepEmbedding
    from emojivoice_tpu_torch.models.text_encoder import MultiHeadAttention

    x = inputs[0] if inputs else None
    if isinstance(module, nn.Conv1d):
        b, _, t_out = output.shape
        k = module.kernel_size[0]
        flops = 2 * b * module.out_channels * t_out * (module.in_channels // module.groups) * k
        return Count().add(flops, _nbytes(x, module.weight, module.bias, output), _kind(x))
    if isinstance(module, nn.ConvTranspose1d):
        b, c_in, t_in = x.shape
        flops = 2 * b * c_in * t_in * (module.out_channels // module.groups) * module.kernel_size[0]
        return Count().add(flops, _nbytes(x, module.weight, module.bias, output), _kind(x))
    if isinstance(module, nn.Linear):
        rows = x.numel() // module.in_features
        return Count().add(2 * rows * module.in_features * module.out_features,
                           _nbytes(x, module.weight, module.bias, output), _kind(x))
    if isinstance(module, MultiHeadAttention):  # x (B, C, T): scores and weighted sum over C = heads · head dim
        b, c, t = x.shape
        return Count().add(4 * b * c * t * t, 4 * (2 * b * module.n_heads * t * t), _kind(x))
    if isinstance(module, Attention):  # x (B, T, dim)
        b, t, _ = x.shape
        inner = module.to_q.out_features
        return Count().add(4 * b * inner * t * t, 4 * (2 * b * module.heads * t * t), _kind(x))
    if isinstance(module, TimestepEmbedding):  # its linears run through F.linear, which no hook sees
        rows = x.numel() // module.linear_1.in_features
        n = module.linear_1.in_features * module.linear_1.out_features + \
            module.linear_2.in_features * module.linear_2.out_features
        return Count().add(2 * rows * n, 4 * n, "f32")
    return None


def count_call(root: nn.Module, fn, grad: bool = False) -> Count:
    """Run fn() with a forward hook on every layer under `root` → the
    products and bytes of the forward layers it called (the Linears inside a
    TimestepEmbedding are counted by it, once); under no_grad unless `grad`."""
    from emojivoice_tpu_torch.models.decoder import TimestepEmbedding

    total = Count()
    skip = {id(m) for te in root.modules() if isinstance(te, TimestepEmbedding) for m in te.modules() if m is not te}

    def hook(module, inputs, output):
        c = _layer_count(module, inputs, output)
        if c is not None:
            total.__iadd__(c)

    handles = [m.register_forward_hook(hook) for m in root.modules() if id(m) not in skip]
    try:
        with torch.set_grad_enabled(grad):
            fn()
    finally:
        for h in handles:
            h.remove()
    return total


def conv_products(b: int, t_out: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * b * t_out * c_in * c_out * k


def mrf_stage_flops(cfg, c: int, b: int, t: int) -> float:
    """Products of one MRF stage at C channels over T samples: per res-block
    and dilation two convs of k taps (252·B·T·C² for v1)."""
    return sum(2 * len(d) * conv_products(b, t, c, c, k)
               for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))


def hifigan_count(cfg, b: int, frames: int, mrf_kind: str = "k1_3xtf32", by_piece: bool = False):
    """HiFi-GAN's products from its config at (B, frames), the MRF stages as
    `mrf_kind` (K1's 3xTF32 by default, "bf16" in K1's bf16 mode, "f32" for
    plain convs), the rest f32; bytes: mel, weights and waveform once.
    With `by_piece`, also {piece: flops}."""
    pieces = {"conv_pre": conv_products(b, frames, cfg.num_mels, cfg.upsample_initial_channel, 7)}
    t, c = frames, cfg.upsample_initial_channel
    n_params = cfg.num_mels * c * 7 + c
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        pieces[f"ups{i}"] = 2.0 * b * t * c * (c // 2) * k
        n_params += c * (c // 2) * k + c // 2
        t, c = t * u, c // 2
        pieces[f"mrf{i}"] = mrf_stage_flops(cfg, c, b, t)
        n_params += sum(2 * len(d) * (c * c * rk + c) for rk, d in
                        zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))
    pieces["conv_post"] = conv_products(b, t, c, 1, 7)
    n_params += c * 7 + 1
    count = Count()
    for name, f in pieces.items():
        count.add(f, 0.0, mrf_kind if name.startswith("mrf") else "f32")
    count.bytes = 4.0 * (b * frames * cfg.num_mels + n_params + b * t)
    return (count, pieces) if by_piece else count


def denoiser_count(b: int, samples: int, n_fft: int = 1024, hop: int = 256) -> Count:
    """STFT and inverse STFT of the denoiser: per frame one real FFT each way
    at the conventional 5·N·log2 N / 2, and the mask's few operations per bin."""
    frames = samples // hop + 1
    bins = n_fft // 2 + 1
    fft = 2 * 5 * n_fft * math.log2(n_fft) / 2
    return Count().add(b * frames * (fft + 8 * bins), 4.0 * b * (2 * samples + frames * bins * 2 * 3))


# ---------------------------------------------------------------------- #
# the measurement
# ---------------------------------------------------------------------- #

class Timer:
    """Times calls in two passes: each call's synchronised walls when it is
    registered, and the profiled device time of every registered call only
    after the last wall (after its first ``torch.profiler`` session a
    process's calls ran slower).  A registered record is [device ms, wall ms]."""

    def __init__(self, device, repeats: int):
        self.device, self.repeats, self.jobs = device, repeats, []

    def __call__(self, fn) -> list:
        fn()  # warm
        rec = [None, util.time_median(lambda: (fn(), util.sync(self.device)), self.repeats)]
        self.jobs.append((fn, rec))
        return rec

    def profile_all(self) -> None:
        for fn, rec in self.jobs:
            rec[0] = statistics.median(util.profile_call(fn, self.device)["device_ms"]
                                       for _ in range(min(3, self.repeats)))


def entry(m: util.Measure, name: str, count: Count, device_ms: float, wall_ms: float) -> dict:
    """The twin's per-program record on this count and these times."""
    flops, nbytes = count.total, count.bytes
    peak = flops / sum(v / PEAKS[k] for k, v in count.flops.items()) / 1e12 if flops else float("nan")
    ridge = peak * 1e12 / util.HBM_BYTES_PER_S
    intensity = flops / nbytes if nbytes else float("nan")
    ceiling = min(peak, intensity * util.HBM_BYTES_PER_S / 1e12)
    achieved = flops / (device_ms * 1e-3) / 1e12 if device_ms else float("nan")
    achieved_wall = flops / (wall_ms * 1e-3) / 1e12 if wall_ms else float("nan")
    return {
        "program": name, "flops_per_call": flops, "gflops_per_call": round(flops / 1e9, 3),
        "flops_by_kind": {k: v for k, v in count.flops.items()},
        "device_ms_per_call": m(device_ms), "wall_ms_per_call": m(wall_ms),
        "achieved_tflops": m(achieved), "achieved_tflops_wall": m(achieved_wall),
        "bytes_per_call": nbytes, "mbytes_per_call": round(nbytes / 1e6, 3),
        "achieved_gbps": m(nbytes / (device_ms * 1e-3) / 1e9 if device_ms else float("nan")),
        "arith_intensity_flop_per_byte": round(intensity, 3),
        "peak_tflops": round(peak, 3), "peak_of": sorted(count.flops),
        "pct_of_peak": m(100.0 * achieved / peak), "pct_of_peak_wall": m(100.0 * achieved_wall / peak),
        "roofline_bound": "memory" if intensity < ridge else "compute", "ridge_intensity": round(ridge, 2),
        "roofline_ceiling_tflops": round(ceiling, 3), "pct_of_roofline_ceiling": m(100.0 * achieved / ceiling),
        "bound_ms": count.bound_s() * 1e3,
    }


def synthesis_count(pipe, x, xl, spk, m_bucket: int, steps: int, vocoder: bool = True) -> dict:
    """Count of each stage of one synthesis call at these inputs, in the
    pipeline's precision: {"encoder", "decoder", "hifigan", "denoiser"}."""
    model = pipe.compute_model
    enc_out = {}

    def encode():
        enc_out["enc"] = model.encode_text(x, xl, spk, 1.0)

    enc = count_call(model, encode)
    mu_x, w_ceil, y_lengths, x_mask, spk_e = enc_out["enc"]
    z = torch.zeros((x.shape[0], m_bucket, pipe.model_cfg.n_feats), device=x.device)
    dec = count_call(model, lambda: model.decode_mel(mu_x, w_ceil, y_lengths, x_mask, spk_e, m_bucket, steps, z))
    b, t_x, c = mu_x.shape
    dec.add(2 * b * t_x * m_bucket * c, _nbytes(mu_x) + 4 * b * (t_x + c) * m_bucket, _kind(mu_x))  # expansion
    out = {"encoder": enc, "decoder": dec}
    if vocoder:
        out["hifigan"] = hifigan_count(pipe.vocoder_cfg, b, m_bucket,
                                       "bf16" if pipe.vocode_dtype == torch.bfloat16 else "k1_3xtf32")
        out["denoiser"] = denoiser_count(b, m_bucket * pipe.vocoder_cfg.total_upsample)
    return out


def total(counts) -> Count:
    out = Count()
    for c in counts:
        out += c
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    util.add_device_args(ap)
    ap.add_argument("--steps", type=int, default=10, help="CFM Euler steps (the bench's)")
    ap.add_argument("--train_batch", type=int, default=8)
    ap.add_argument("--train_tx", type=int, default=96)
    ap.add_argument("--train_ty", type=int, default=384)
    ap.add_argument("--out_size", type=int, default=172)
    ap.add_argument("--voc_frames", type=int, default=512)
    ap.add_argument("--skip_train", action="store_true")
    ap.add_argument("--skip_sweep", action="store_true")
    ap.add_argument("--skip_stages", action="store_true")
    ap.add_argument("--repeats", type=int, default=5, help="synchronised calls per time (and up to 3 profiled)")
    args = ap.parse_args(argv)
    device = util.resolve_device(args.cpu, "bench.mfu")
    m, info = util.Measure(device), util.device_info(device)

    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline, upload
    from emojivoice_tpu_torch.utils.buckets import pick_bucket

    root = config.get_preset(args.preset)
    pipe = SynthesisPipeline.from_random(root, seed=0, device=device, cleaners=("basic_cleaners",))
    spk_id = min(args.spk, root.model.n_spks - 1)
    kw = dict(spks=[spk_id], n_timesteps=args.steps, denoiser_strength=0.00025, keep_mel=False, pcm16=True)
    first = pipe.synthesise([util.HEADLINE], seed=0, **kw)[0]
    m_bucket = pick_bucket(first.mel_length, pipe.mel_buckets)
    x_np, xl_np, _, t_bucket = pipe.encode_texts([util.HEADLINE])
    x, xl = upload(torch.from_numpy(x_np), device), upload(torch.from_numpy(xl_np), device)
    spk = pipe._speakers([spk_id], 1)
    timed = Timer(device, args.repeats)
    rows = []  # (section, name, count, [device ms, wall ms]); entries are made once every call is profiled

    def fused(p):
        return lambda: p.synthesise([util.HEADLINE], seed=0, fused=True, fused_mel_bucket=m_bucket, **kw)

    counts = synthesis_count(pipe, x, xl, spk, m_bucket, args.steps)
    t_syn = timed(fused(pipe))
    rows.append(("programs", f"fused_synthesis_b1_t{t_bucket}_m{m_bucket}_{args.steps}steps", total(counts.values()),
                 t_syn))
    if not args.skip_stages:
        enc = {}

        def run_encoder():
            enc["out"] = pipe.model.encode_text(x, xl, spk, 1.0)

        t_enc = timed(run_encoder)
        mu_x, w_ceil, y_lengths, x_mask, spk_e = enc["out"]
        z = torch.zeros((1, m_bucket, root.model.n_feats), device=device)
        mel = {}

        def run_decoder():
            mel["out"] = pipe.model.decode_mel(mu_x, w_ceil, y_lengths, x_mask, spk_e, m_bucket, args.steps, z)

        t_dec = timed(run_decoder)
        wav = {}

        def run_vocoder():
            wav["out"] = pipe._vocode(mel["out"]["mel"])

        t_voc = timed(run_vocoder)
        t_den = timed(lambda: pipe.denoiser(wav["out"], 0.00025))
        n_samp = wav["out"].shape[1]
        for name, key, t in ((f"encoder_b1_t{t_bucket}", "encoder", t_enc),
                             (f"cfm_decode_b1_t{t_bucket}_m{m_bucket}_{args.steps}steps", "decoder", t_dec),
                             (f"hifigan_k1_b1_m{m_bucket}", "hifigan", t_voc),
                             (f"denoiser_b1_{n_samp}samp", "denoiser", t_den)):
            rows.append(("stages", name, counts[key], t))

    if not args.skip_sweep:
        def variant(**kw_p):
            return SynthesisPipeline(root.model, pipe.model, root.vocoder, pipe.vocoder, device=device,
                                     cleaners=("basic_cleaners",), **kw_p)

        for label, p, is_fused in (("fused_f32_k1", pipe, True),
                                   ("fused_f32_acoustic_bf16_voc", variant(vocoder_dtype=torch.bfloat16), True),
                                   ("fused_all_bf16", variant(compute_dtype=torch.bfloat16), True),
                                   ("two_stage_f32_k1", pipe, False),
                                   ("two_stage_decoder_bf16", variant(compute_dtype=torch.bfloat16), False)):
            call = fused(p) if is_fused else (lambda p=p: p.synthesise([util.HEADLINE], seed=0, **kw))
            c = total(synthesis_count(p, x, xl, spk, m_bucket, args.steps).values())
            rows.append(("precision_sweep", label, c, timed(call)))

    if not args.skip_train:
        from emojivoice_tpu_torch.training.state import batch_to_device, create_train_state, train_step

        model_cfg = dataclasses.replace(root.model, out_size=args.out_size)
        state = create_train_state(model_cfg, root.optimizer, seed=0, device=device)
        b, tx, ty = args.train_batch, args.train_tx, args.train_ty
        rng = np.random.default_rng(0)
        batch = batch_to_device({
            "x": rng.integers(1, 170, (b, tx)), "x_lengths": np.full((b,), tx),
            "y": rng.normal(size=(b, ty, model_cfg.n_feats)).astype(np.float32), "y_lengths": np.full((b,), ty),
            "spks": rng.integers(0, model_cfg.n_spks, (b,))}, device)
        fwd = count_call(state.model, lambda: train_step(state, batch, 0), grad=True)  # the backward runs no hook
        out = min(args.out_size, ty)
        fwd.add(2 * b * tx * ty * model_cfg.n_feats + 2 * b * tx * out * model_cfg.n_feats)  # log-prior, expansion
        rows.append(("programs", f"train_step_b{b}_tx{tx}_ty{ty}_outsize{args.out_size}", fwd.scaled(3.0),
                     timed(lambda: train_step(state, batch, 0))))

    mel_v = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, args.voc_frames, root.vocoder.num_mels)).astype(np.float32)).to(device)
    rows.append(("programs", f"hifigan_b1_t{args.voc_frames}", hifigan_count(root.vocoder, 1, args.voc_frames),
                 timed(lambda: pipe.vocoder(mel_v))))

    timed.profile_all()
    report = {"device_kind": info["device"], "backend": device.type, "torch": torch.__version__,
              "cuda": torch.version.cuda, "compute_dtype": "float32"}
    sections = {"programs": [], "stages": [], "precision_sweep": []}
    for section, name, count, (dev, wall) in rows:
        sections[section].append(entry(m, name, count, dev, wall))
    if not args.skip_stages:
        stage_sum = sum(t[0] for t in (t_enc, t_dec, t_voc, t_den))
        report["stages"] = {"programs": sections["stages"], "stage_sum_ms": m(stage_sum), "fused_ms": m(t_syn[0]),
                            "fusion_gain_pct": m(100.0 * (1 - t_syn[0] / stage_sum) if stage_sum else None)}
    if not args.skip_sweep:
        report["precision_sweep"] = sections["precision_sweep"]
    entries = sections["programs"]
    report.update({
        "note": ("FLOPs and bytes are the port's own count from shapes (products, two per multiply-add; "
                 "elementwise work uncounted; bytes each counted layer's input, weights and output once); "
                 "device ms is the summed device activity of a profiled call, wall ms a synchronised call; the "
                 "peak combines each kind of product's own (f32 67, K1 3xTF32 495/3, bf16 989 TFLOP/s)"),
        "power_limit_w": info["power_limit_w"], "programs": entries})
    report.update(info)
    util.emit(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
