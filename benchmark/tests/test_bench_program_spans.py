"""The readers of the engine's counters of its host phases, on synthetic
records: each returns its mean per dispatched batch over the window where
the engine keeps the counter, and nothing where it does not (a program
without the counters) or where no batch was dispatched."""

from __future__ import annotations

import pytest

from benchmark.harness import ROOT, Record, Spans, load_module


def reader(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py", f"metric_{name}").read


def record(before, after):
    return Record(cell="c", window_s=30.0, setup_s=1.0, items=[], spans=Spans(),
                  counters=dict(before=dict(engine=before), after=dict(engine=after)))


ENGINE = dict(batches=2, requests=8, wait_s_sum=0.8, collect_s_sum=0.03, slot_wait_s_sum=0.001,
              frontend_s_sum=0.004, host_read_s_sum=0.25)


@pytest.mark.parametrize("name, key", [("engine.collect_ms.serve", "collect_s_sum"),
                                       ("engine.slot_wait_ms.serve", "slot_wait_s_sum"),
                                       ("pipeline.frontend_ms.serve", "frontend_s_sum"),
                                       ("pipeline.host_read_ms.serve", "host_read_s_sum")])
def test_engine_counter_readers(name, key):
    after = {k: 3 * v for k, v in ENGINE.items()}
    assert reader(name)(record(ENGINE, after)) == pytest.approx(1e3 * 2 * ENGINE[key] / 4)
    old = {k: ENGINE[k] for k in ("batches", "requests", "wait_s_sum")}  # an engine without the new counters
    assert reader(name)(record(old, {k: 3 * v for k, v in old.items()})) is None
    assert reader(name)(record(ENGINE, ENGINE)) is None  # no batch in the window
