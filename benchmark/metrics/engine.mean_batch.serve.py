"""The engine's mean rows per dispatched batch over the window (its
counters ``batched_rows`` over ``batches``; pad rows not counted)."""


def read(record):
    a, b = record.counters["after"]["engine"], record.counters["before"]["engine"]
    n = a["batches"] - b["batches"]
    return (a["batched_rows"] - b["batched_rows"]) / n if n else None
