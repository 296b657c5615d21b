"""RTF of the exported bundle beside the live pipeline on the card (twin of ``tools/bench_exported.py``).

    python -m emojivoice_tpu_torch.bench.exported [--repeats 10] [--bundle DIR] [--eager]

Exports one (batch 1, text bucket 256, mel bucket 512) program of
emoji_multi + HiFi-GAN v1 (random weights, seed 0) through
``inference/export.py::export_bundle`` (10 Euler steps, pcm16; K1 runs inside
the program as the registered op ``emojivoice_tpu_torch::mrf_stage``), loads
it with ``LoadedBundle``, and times warmed calls of the bench's headline text
(speaker 3, seed 0) through the bundle and through the live pipeline, fused
at mel bucket 512, pcm16, in turns (live, bundle, bundle, live).  The text
bucket is the twin's code's 256 (the headline's 231 interspersed ids do not
fit its docstring's 128).  The bundle goes to a temporary folder unless
``--bundle`` names one; nothing is written under ``docs/artifacts/``.  Both
sides run through captured CUDA graphs (the bundle's programs one graph each,
``inference/export.py``; the live stages, ``inference/graphs.py``), the
card's default; ``--eager`` runs both op by op.

Prints one JSON line with the twin's keys (``exported`` / ``live``:
``audio_s``, ``wall_s_mean``, ``wall_s_std``, ``rtf``; ``export_wall_s``),
each side's median and min wall, K1's ``mrf_stage`` calls per call on each
side, the largest difference between the two waveforms, the card's name,
count and power limit, and how each side ran (``graphs_exported``,
``graphs_live``: ``bench/util.py::graphs_info``).
"""

from __future__ import annotations

import argparse
import datetime as dt
import statistics
import tempfile
import time

import numpy as np

from emojivoice_tpu_torch.bench import util

TEXT = util.HEADLINE
TEXT_BUCKET, MEL_BUCKET = 256, 512


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    util.add_device_args(ap)
    ap.add_argument("--bundle", default=None, help="folder for the bundle (default: a temporary one)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--repeats", type=int, default=10)
    util.add_eager_arg(ap)
    args = ap.parse_args(argv)
    device = util.resolve_device(args.cpu, "bench.exported")
    m, info = util.Measure(device), util.device_info(device)

    from emojivoice_tpu_torch import config
    from emojivoice_tpu_torch.inference.export import LoadedBundle, export_bundle
    from emojivoice_tpu_torch.inference.pipeline import SAMPLE_RATE, SynthesisPipeline

    graphs = False if args.eager else None
    pipe = SynthesisPipeline.from_random(config.get_preset(args.preset), seed=0, device=device,
                                         cleaners=("basic_cleaners",), graphs=graphs)
    spk = min(3, pipe.model_cfg.n_spks - 1)
    with tempfile.TemporaryDirectory(prefix="emojivoice_exported_") as tmp:
        bundle_dir = args.bundle or tmp
        t0 = dt.datetime.now()
        export_bundle(pipe, bundle_dir, text_buckets=[TEXT_BUCKET], mel_buckets=[MEL_BUCKET],
                      batches=(1,), n_timesteps=args.steps, pcm16=True)
        export_s = (dt.datetime.now() - t0).total_seconds()
        runner = LoadedBundle(bundle_dir, device=device, graphs=graphs)

        def run_exported():
            results, _ = runner.synthesise([TEXT], spks=[spk], seed=0)
            return results[0]["wav"].astype(np.float32) / 32767.0  # a pcm16 bundle returns int16 samples

        def run_live():
            return pipe.synthesise([TEXT], spks=[spk], n_timesteps=args.steps, seed=0, fused=True,
                                   fused_mel_bucket=MEL_BUCKET, keep_mel=False, pcm16=True)[0].wav

        wavs, walls, launches = {}, {"exported": [], "live": []}, {}
        for name, fn in (("live", run_live), ("exported", run_exported)):
            fn()  # warm (the program's first load and run)
            before = util.k1_calls()
            wavs[name] = fn()
            launches[name] = util.k1_calls() - before
        half = max(args.repeats // 2, 1)
        for name, fn in (("live", run_live), ("exported", run_exported), ("exported", run_exported),
                         ("live", run_live)):
            for _ in range(half):
                t = time.perf_counter()
                fn()
                walls[name].append(time.perf_counter() - t)

    def side(name):
        audio = len(wavs[name]) / SAMPLE_RATE
        w = walls[name]
        return {"audio_s": round(audio, 3), "wall_s_mean": m(float(np.mean(w))), "wall_s_std": m(float(np.std(w))),
                "rtf": m(float(np.mean(w)) / audio), "wall_ms_median": m(statistics.median(w) * 1e3),
                "wall_ms_min": m(min(w) * 1e3), "k1_launches": launches[name]}

    n = min(len(wavs["live"]), len(wavs["exported"]))
    report = {
        "backend": device.type, "text_chars": len(TEXT), "steps": args.steps, "repeats": 2 * half,
        "text_bucket": TEXT_BUCKET, "mel_bucket": MEL_BUCKET, "export_wall_s": m(export_s),
        "exported": side("exported"), "live": side("live"),
        "same_length": len(wavs["live"]) == len(wavs["exported"]),
        "wav_max_abs_diff": float(np.abs(wavs["live"][:n] - wavs["exported"][:n]).max()) if n else None,
        "graphs_exported": util.graphs_info(runner), "graphs_live": util.graphs_info(pipe),
        "generated": dt.datetime.now().isoformat(timespec="seconds"), **info,
    }
    util.emit(report)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
