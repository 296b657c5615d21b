"""The harness: BENCHMARK.json and the files it names, the import guard, and
that a new configuration, traffic mix, cell and metric are found by name
when only files and entries are added (in a copy of the benchmark)."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_has_its_files():
    b = ROOT / "benchmark"
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and (b / "configs" / f"{c['name']}.py").exists()
    for w in BENCH["workloads"]:
        cell = json.loads((b / "cells" / f"{w['name']}.json").read_text())
        assert (b / "drivers" / f"{cell['driver']}.py").exists()
        assert (b / "traffic" / f"{w['traffic']}.json").exists()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (b / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_benchmark_json_keeps_the_contracts_shapes():
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for w in BENCH["workloads"]:
        reported = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert {"setup_s"} < {m["name"] for m in reported}
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import torch; torch.set_num_threads(2)\n"
            "from benchmark import run as R, harness; from benchmark.tests import tiny\n"
            "R.run('agent_turn_gptj', 5, 0.5, False, 'cpu', configs=tiny.configs())\n"
            "print('LOADED', harness.forbidden_modules())") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert "LOADED []" in out.stdout, out.stderr[-2000:]


def test_new_files_are_found_by_name(tmp_path):
    """A dummy configuration, mix, cell and metric added as files and entries
    in a copy: the harness runs the new cell and reads the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    (b / "configs" / "dummy_voice.json").write_text(json.dumps(tiny.matcha()))
    (b / "configs" / "dummy_voice.py").write_text(
        "from benchmark.configs.matcha_emoji_v1 import build, reference_weights  # noqa: F401\n")
    mix = json.loads((b / "traffic" / "poisson_replies.json").read_text())
    mix["arrivals"]["rate_per_s"] = 6.0
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    cell = json.loads((b / "cells" / "tts_serve_poisson.json").read_text())
    (b / "cells" / "dummy_cell.json").write_text(json.dumps(cell))
    (b / "metrics" / "dummy_requests.py").write_text("def read(record):\n    return len(record.items)\n")
    bench["configs"].append(dict(bench["configs"][0], name="dummy_voice", file="benchmark/configs/dummy_voice.json"))
    bench["workloads"].append(dict(name="dummy_cell", config="dummy_voice", traffic="dummy_mix", chips=1, why="a test"))
    bench["end_to_end"].append(dict(name="dummy_requests", unit="count", better="higher", bound=0.25,
                                    source="host_clock", workloads=["dummy_cell"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    from benchmark import run as R

    torch.set_num_threads(4)
    res = R.run("dummy_cell", 9, 1.0, False, "cpu", root=root)
    assert res["correct"], res["checks"]
    assert res["metrics"]["dummy_requests"]["value"] == res["attempted"] > 0
    assert set(res["metrics"]) == {"dummy_requests", "setup_s"}


def test_no_result_without_a_card(monkeypatch, capsys):
    from benchmark import run as R

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        R.main(["--workload", "tts_serve_poisson", "--seed", "1", "--seconds", "1", "--trace", "0"])
    except SystemExit as e:
        assert e.code != 0
    else:
        raise AssertionError("ran without a card")
    assert capsys.readouterr().out == ""
