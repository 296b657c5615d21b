"""The port's benchmark: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names its
configuration and traffic mix; the harness finds their files by name:
``configs/<config>.json`` with its builder ``configs/<config>.py``,
``traffic/<mix>.json`` (read by ``traffic/generate.py``) and
``cells/<cell>.json`` (the driver, ``drivers/<driver>.py``, and its
settings).  Each metric of ``BENCHMARK.json`` that applies to the cell is
read by ``metrics/<metric>.py``.

A run makes its inputs and weights from ``--seed`` on the card, warms every
shape its traffic reaches (set-up), measures for ``--seconds``, then frees
the system and checks what the window served against the plain reference
(``reference/``), and prints one JSON line: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a
profiled slice of the window.  It exits with another code than 0, and
prints no result, without a CUDA device, or when JAX or the JAX package has
been loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# transformers looks for TensorFlow and Flax on its first import, and TensorFlow imports JAX
os.environ.update(USE_TORCH="1", USE_TF="0", USE_FLAX="0")
# one thread for the host's math libraries: no pool of spinning threads beside the loop that feeds the card
os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
# every kernel cache at a fixed path inside the checkout: later runs find what the first one built
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "bench_cache" / sub)

from benchmark import harness  # noqa: E402
from benchmark.traffic import generate  # noqa: E402


WATCHDOG_S = 330  # a run that has not ended by then prints every thread's stack and exits with 1


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def read_metrics(bench: dict, kind: str, cell: str, record, bench_dir: Path = BENCH_DIR) -> dict:
    out = {}
    for m in bench[kind]:
        if not applies(m, cell):
            continue
        reader = harness.load_module(bench_dir / "metrics" / f"{m['name']}.py", f"metric_{m['name']}")
        value = reader.read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(numbers: dict, limits: dict) -> dict:
    """Each number the cell compares, beside its limit."""
    return {k: {"value": float(numbers[k]), "limit": float(v)} for k, v in limits.items()}


def passes(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run(workload: str, seed: int, seconds: float, trace: bool, device, control: bool = False, root: Path = ROOT,
        configs: dict | None = None) -> dict:
    """One run of `workload` on `device` → the result line's object.
    `control` also judges the control (the reference in TF32 put in the
    program's place, read on the same rows and positions) by the same
    limits, into the line's ``control``.  `configs`
    (name → configuration) stands in for configuration files (the tests run
    tiny ones on the CPU)."""
    import torch

    bench = harness.load_json(root / "BENCHMARK.json")
    bench_dir = root / "benchmark"
    w = {c["name"]: c for c in bench["workloads"]}[workload]
    cell = dict(harness.load_json(bench_dir / "cells" / f"{workload}.json"), name=workload)
    cfg = (configs or {}).get(w["config"]) or harness.load_json(bench_dir / "configs" / f"{w['config']}.json")
    on_card = torch.device(device).type == "cuda"
    if on_card:  # the configurations' float32 products: TF32 off
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    builder = harness.load_module(bench_dir / "configs" / f"{w['config']}.py", f"config_{w['config']}")
    driver_mod = harness.load_module(bench_dir / "drivers" / f"{cell['driver']}.py", f"driver_{cell['driver']}")
    traffic = generate.make(w["traffic"], seed, seconds, bench_dir / "traffic")
    system = builder.build(cfg, seed, device)
    driver = driver_mod.Driver(cell, system, traffic, device, seed)
    try:
        driver.warm()
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - T_PROCESS
        record = driver.window(seconds, trace)
        record.setup_s = setup_s
        record.extra["config"] = cfg
        if on_card:
            torch.cuda.synchronize()
    finally:
        driver.close()
    loaded = harness.forbidden_modules()
    if loaded:
        fail(f"the run loaded {loaded}: the benchmark measures the PyTorch port alone")
    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": w["chips"],
               "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i) for i in range(w["chips"])))}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    metrics = read_metrics(bench, "per_layer" if trace else "end_to_end", workload, record, bench_dir)

    # the check: the system freed, the reference in float32 with TF32 off, from the seed's weights again
    system.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    limits = cell["limits"]
    t_check = time.perf_counter()
    numbers = driver.check(record, lambda which: builder.reference_weights(cfg, seed, device, which), control)
    check_s = time.perf_counter() - t_check
    checks = judge(numbers, limits)
    loaded = harness.forbidden_modules()
    if loaded:
        fail(f"the run loaded {loaded}: the benchmark measures the PyTorch port alone")
    attempted, failed = driver_mod.outcome(record)
    info = {k: v for k, v in numbers.items() if k not in limits and not k.startswith("control_")}
    print(f"[bench] {workload} seed {seed}: window {record.window_s:.3f} s, set-up {setup_s:.3f} s, "
          f"check {check_s:.1f} s, {info} {record.extra.get('notes', {})}", file=sys.stderr)
    result = {"correct": passes(checks), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if record.trace is not None:
        result["device"].update(busy_s=record.trace.busy_s, window_s=record.trace.window_s)
        result["breakdown"] = record.trace.breakdown()
    if control:
        readings = {k[len("control_"):]: v for k, v in numbers.items() if k.startswith("control_")}
        control_checks = judge(readings, limits)
        result["control"] = {"correct": passes(control_checks), "checks": control_checks, "readings": readings}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also judge the control: the reference in TF32 put in the program's place")
    args = ap.parse_args(argv)
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        fail(f"no workload {args.workload!r} in BENCHMARK.json")
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"needs {chips} CUDA device(s); torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    torch.cuda.set_device(0)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), args.control)
    print(f"[bench] card: {power_limit()}", file=sys.stderr)
    if "control" in result:
        ctl = result["control"]
        print(f"[control] correct {ctl['correct']} {ctl['readings']}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"[check] {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    sys.exit(main())
