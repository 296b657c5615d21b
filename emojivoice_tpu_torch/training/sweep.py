"""`emojivoice-sweep-torch` — hyperparameter search over the port's training
CLI (PyTorch port of ``emojivoice_tpu.training.sweep``, the port's own copy).

The reference ships a Hydra Optuna sweeper config
(reference: Matcha-TTS/configs/hparams_search/mnist_optuna.yaml:1-52 — a
lightning-hydra-template leftover, pointing at nonexistent mnist configs)
and Hydra `-m` multirun.  This is the working analog: grid or random search
over any `emojivoice-train` flag, one out_dir per trial, a jsonl trial log,
and a ranked summary by a metrics.jsonl objective.  Each record says where
its objective came from (``"objective_from": "val"`` for the requested tag,
``"train"`` where that tag never fired and the last train record stood in, as
the JAX sweep ranks it without saying so).

Space specs (repeatable ``--space NAME=SPEC``):

    NAME=choice:a,b,c     categorical (strings passed through verbatim)
    NAME=log:LO:HI        continuous, log-uniform   (random search only)
    NAME=lin:LO:HI        continuous, uniform       (random search only)
    NAME=int:LO:HI        integer, uniform inclusive (random search only)

``--grid`` enumerates the cross product of choice specs (the Hydra `-m`
comma-list analog); otherwise ``--trials N`` random-samples (the Optuna
TPESampler analog is deliberately plain random — no optuna in the image,
and at N≲20 random search is a near-match, Bergstra & Bengio 2012).

Trials run one after another in this process; a failed trial is recorded
with its error and the sweep continues, like Optuna's failed-trial handling.
After each trial, failed or not, what it held is released (its model,
optimizer and loggers go with the trainer's frame; the garbage collector and
the CUDA caching allocator are run), so the next trial starts with the card's
memory as the first found it.  Everything after ``--`` is passed to every
trial verbatim.

Example:

    emojivoice-sweep-torch --out_dir sweeps/s1 --trials 4 \\
        --space lr=log:1e-5:1e-3 --space scheduler=choice:constant,cosine \\
        -- --preset tiny --train_filelist t.txt --valid_filelist v.txt \\
           --max_steps 200
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import math
import random
import traceback
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch


@dataclass
class SpaceSpec:
    name: str
    kind: str  # choice | log | lin | int
    choices: Optional[List[str]] = None
    lo: float = 0.0
    hi: float = 0.0

    def sample(self, rng: random.Random):
        if self.kind == "choice":
            return rng.choice(self.choices)
        if self.kind == "log":
            return math.exp(rng.uniform(math.log(self.lo), math.log(self.hi)))
        if self.kind == "lin":
            return rng.uniform(self.lo, self.hi)
        return rng.randint(int(self.lo), int(self.hi))


def parse_space(spec: str) -> SpaceSpec:
    if "=" not in spec:
        raise ValueError(f"--space needs NAME=SPEC, got {spec!r}")
    name, body = spec.split("=", 1)
    kind, _, rest = body.partition(":")
    if kind == "choice":
        choices = [c for c in rest.split(",") if c]
        if not choices:
            raise ValueError(f"--space {name}: choice needs at least one value")
        return SpaceSpec(name, "choice", choices=choices)
    if kind in ("log", "lin", "int"):
        try:
            lo_s, hi_s = rest.split(":")
            lo, hi = float(lo_s), float(hi_s)
        except ValueError as e:
            raise ValueError(f"--space {name}: {kind} needs LO:HI, got {rest!r}") from e
        if not (hi >= lo) or (kind == "log" and lo <= 0):
            raise ValueError(f"--space {name}: bad range {lo}..{hi} for {kind}")
        return SpaceSpec(name, kind, lo=lo, hi=hi)
    raise ValueError(f"--space {name}: unknown kind {kind!r} "
                     "(choice | log | lin | int)")


def build_trials(spaces: Sequence[SpaceSpec], grid: bool, trials: int,
                 seed: int) -> List[dict]:
    if grid:
        bad = [s.name for s in spaces if s.kind != "choice"]
        if bad:
            raise ValueError(f"--grid needs choice spaces only; continuous: {bad}")
        combos = itertools.product(*[s.choices for s in spaces])
        return [dict(zip([s.name for s in spaces], c)) for c in combos]
    rng = random.Random(seed)
    return [{s.name: s.sample(rng) for s in spaces} for _ in range(trials)]


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def read_objective(run_dir: Path, objective: str) -> Optional[float]:
    """Objective from a trial's metrics.jsonl: ``TAG/KEY`` (default
    ``val/loss``) takes the LAST record of that tag; falls back to the last
    ``train`` record when the tag never fired (e.g. --val_every_steps 0).
    ``read_objective_with_source`` also says which of the two it was."""
    return read_objective_with_source(run_dir, objective)[0]


def read_objective_with_source(run_dir: Path, objective: str) -> Tuple[Optional[float], Optional[str]]:
    """(objective, the tag it came from: the requested one, ``"train"`` for the
    fallback, or None with no value)."""
    path = run_dir / "metrics.jsonl"
    if not path.exists():
        return None, None
    tag, _, key = objective.partition("/")
    key = key or "loss"
    best = None
    fallback = None
    for line in path.read_text().splitlines():
        rec = json.loads(line)
        if rec.get("tag") == tag and key in rec:
            best = rec[key]
        elif rec.get("tag") == "train" and key in rec:
            fallback = rec[key]
    if best is not None:
        return float(best), tag
    return (None, None) if fallback is None else (float(fallback), "train")


def _release() -> None:
    """Free what a finished trial left: objects in reference cycles, and the
    CUDA caching allocator's blocks that no tensor holds any more."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_sweep(trials: List[dict], out_dir: Path, train_args: List[str],
              objective: str = "val/loss", minimize: bool = True,
              train_main=None) -> dict:
    """Run every trial, append one jsonl record each, return the summary.

    ``train_main`` is injectable for tests; defaults to the port's trainer.
    """
    if train_main is None:
        from emojivoice_tpu_torch.training.train import main as train_main
    out_dir.mkdir(parents=True, exist_ok=True)
    log_path = out_dir / "trials.jsonl"
    results = []
    for i, params in enumerate(trials):
        run_dir = out_dir / f"trial_{i:03d}"
        argv = list(train_args) + ["--out_dir", str(run_dir)]
        for k, v in params.items():
            argv += [f"--{k}", _fmt(v)]
        rec = {"trial": i, "params": {k: (_fmt(v) if isinstance(v, float) else v)
                                      for k, v in params.items()},
               "out_dir": str(run_dir)}
        print(f"[sweep] trial {i}/{len(trials) - 1}: "
              + " ".join(f"{k}={_fmt(v)}" for k, v in params.items()), flush=True)
        try:
            rc = train_main(argv)
            rec["status"] = "ok" if rc == 0 else f"exit {rc}"
        except SystemExit as e:  # argparse errors inside the trial
            rec["status"] = f"exit {e.code}"
        except Exception as e:  # noqa: BLE001 — a diverged/crashed trial must
            # not kill the sweep (Optuna marks it FAILED and moves on)
            rec["status"] = f"error: {type(e).__name__}: {e}"
            (run_dir / "sweep_error.log").parent.mkdir(parents=True, exist_ok=True)
            (run_dir / "sweep_error.log").write_text(traceback.format_exc())
        _release()
        rec["objective"], rec["objective_from"] = read_objective_with_source(run_dir, objective)
        results.append(rec)
        with open(log_path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    scored = [r for r in results if r["objective"] is not None
              and math.isfinite(r["objective"])]
    ranked = sorted(scored, key=lambda r: r["objective"], reverse=not minimize)
    summary = {
        "objective": objective,
        "direction": "minimize" if minimize else "maximize",
        "n_trials": len(results),
        "n_failed": sum(1 for r in results if r["objective"] is None),
        "ranking": [{"trial": r["trial"], "objective": r["objective"],
                     "objective_from": r["objective_from"], "params": r["params"]} for r in ranked],
        "best": ranked[0] if ranked else None,
    }
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=1))
    if ranked:
        b = ranked[0]
        print(f"[sweep] best: trial {b['trial']}  {objective}={b['objective']:.6g} "
              f"(from {b['objective_from']})  "
              + " ".join(f"{k}={v}" for k, v in b["params"].items()), flush=True)
    else:
        print("[sweep] no trial produced a finite objective", flush=True)
    return summary


def main(argv=None) -> int:
    if argv is None:
        import sys

        argv = sys.argv[1:]
    argv = list(argv)
    train_args: List[str] = []
    if "--" in argv:
        split = argv.index("--")
        argv, train_args = argv[:split], argv[split + 1:]

    p = argparse.ArgumentParser(
        prog="emojivoice-sweep-torch",
        description="Grid/random hyperparameter search over emojivoice-train-torch "
                    "(the reference's Hydra multirun/Optuna-sweeper analog). "
                    "Arguments after -- go to every trial verbatim.")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--space", action="append", default=[], metavar="NAME=SPEC",
                   help="NAME=choice:a,b,c | NAME=log:LO:HI | NAME=lin:LO:HI "
                        "| NAME=int:LO:HI (repeatable)")
    p.add_argument("--grid", action="store_true",
                   help="cross product of choice spaces (Hydra -m analog) "
                        "instead of random sampling")
    p.add_argument("--trials", type=int, default=8,
                   help="random-search trial count (ignored with --grid)")
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--objective", default="val/loss",
                   help="TAG/KEY picked from each trial's metrics.jsonl "
                        "(last record wins; train fallback)")
    p.add_argument("--maximize", action="store_true",
                   help="rank descending (default: minimize)")
    args = p.parse_args(argv)
    if not args.space:
        p.error("at least one --space is required")
    if not train_args:
        p.error("pass the shared training flags after `--` "
                "(e.g. -- --preset tiny --train_filelist ...)")
    try:
        spaces = [parse_space(s) for s in args.space]
        trials = build_trials(spaces, args.grid, args.trials, args.seed)
    except ValueError as e:
        p.error(str(e))
    summary = run_sweep(trials, Path(args.out_dir), train_args,
                        objective=args.objective, minimize=not args.maximize)
    return 0 if summary["best"] is not None else 1


if __name__ == "__main__":
    raise SystemExit(main())
