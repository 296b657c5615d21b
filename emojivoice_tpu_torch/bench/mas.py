"""K2 against the plain monotonic alignment search at training shapes on the
card (twin of ``tools/bench_mas.py``).

    python -m emojivoice_tpu_torch.bench.mas [--b 16 --tx 256 --ty 768] [--also_ty 1536] [--iters 5]

A seeded random log-prior (B, T_x, T_y) with ragged lengths (T_x and T_y
each drawn in [T/2, T]) and its mask, as the twin makes them.  Each backend
of ``--backends`` (``k2``: ``ops/mas.py::maximum_path``, K2 on the card;
``plain``: ``maximum_path_reference``) must give the path of
``maximum_path_numpy`` to the bit, and is then timed: device ms by CUDA
events, the median of ``--iters`` runs of ``--reps`` calls each, over
``--reps``.  ``--also_ty`` repeats the whole at another T_y (1536, the
training batch's mel bucket, by default).

The twin printed one line per backend and a speed-up line; here they are
the entries of ``lines`` in one JSON line (``mas_jax_ms`` / ``mas_pallas_ms``
→ ``mas_plain_ms`` / ``mas_k2_ms``, ``mas_pallas_speedup`` →
``mas_k2_speedup``; ``compile_s`` is the first call's wall, the kernel's
build included), with the card's name, count and power limit.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from emojivoice_tpu_torch.bench import util


def problem(b: int, tx: int, ty: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    t_xs = rng.integers(tx // 2, tx + 1, size=b)
    t_ys = rng.integers(ty // 2, ty + 1, size=b)
    value = rng.normal(size=(b, tx, ty)).astype(np.float32)
    mask = np.zeros_like(value)
    for i in range(b):
        mask[i, : t_xs[i], : t_ys[i]] = 1.0
    return value, mask


def run_shape(b, tx, ty, backends, reps, iters, device, m) -> list:
    from emojivoice_tpu_torch.ops.mas import maximum_path, maximum_path_numpy, maximum_path_reference

    value, mask = problem(b, tx, ty)
    want = maximum_path_numpy(value * mask, mask)
    v, msk = torch.from_numpy(value).to(device), torch.from_numpy(mask).to(device)
    fns = {"k2": maximum_path, "plain": maximum_path_reference}
    lines, results = [], {}
    for backend in backends:
        fn = fns[backend]
        t0 = time.perf_counter()
        got = fn(v, msk)
        util.sync(device)
        compile_s = time.perf_counter() - t0
        exact = bool(np.array_equal(got.cpu().numpy(), want))
        if not exact:
            raise RuntimeError(f"mas {backend} at ({b}, {tx}, {ty}): the path differs from maximum_path_numpy")
        n = reps if backend == "k2" else 1  # the plain loop takes hundreds of ms a call

        def rep(fn=fn, n=n):
            for _ in range(n):
                fn(v, msk)

        per_call = util.event_ms(rep, device, iters, 1) / n
        results[backend] = per_call
        lines.append({"metric": f"mas_{backend}_ms", "value": m(per_call), "unit": "ms", "shape": [b, tx, ty],
                      "compile_s": m(compile_s), "exact": exact})
    if "k2" in results and "plain" in results:
        lines.append({"metric": "mas_k2_speedup", "value": m.ratio(results["plain"], results["k2"]), "unit": "x",
                      "shape": [b, tx, ty]})
        # the least time of K2's work: the value and mask read once, the path written once; two f32 operations
        # per cell of the search at the f32 peak
        nbytes = 3 * 4 * b * tx * ty
        lines[-1]["bound_ms"] = max(nbytes / util.HBM_BYTES_PER_S, 2 * b * tx * ty / util.F32_FLOPS) * 1e3
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    util.add_device_args(p, preset=False)
    p.add_argument("--b", type=int, default=16)
    p.add_argument("--tx", type=int, default=256)
    p.add_argument("--ty", type=int, default=768)
    p.add_argument("--also_ty", type=int, default=1536, help="a second T_y (0: none)")
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--backends", default="k2,plain")
    args = p.parse_args(argv)
    device = util.resolve_device(args.cpu, "bench.mas")
    m, info = util.Measure(device), util.device_info(device)
    from emojivoice_tpu_torch.ops import mas

    backends = [b for b in args.backends.split(",") if b]
    before = mas.launches
    lines = []
    for ty in [args.ty] + ([args.also_ty] if args.also_ty else []):
        lines += run_shape(args.b, args.tx, ty, backends, args.reps, args.iters, device, m)
    util.emit({"metric": "mas", "lines": lines, "k2_launches": mas.launches - before, **info})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
