"""The engine's worker blocked on an in-flight slot before a dispatch, mean
per dispatched batch over the window (the engine's counters
``slot_wait_s_sum`` over ``batches``), milliseconds; nothing where the
engine keeps no such counter."""


def read(record):
    a, b = record.counters["after"]["engine"], record.counters["before"]["engine"]
    n = a["batches"] - b["batches"]
    return 1e3 * (a["slot_wait_s_sum"] - b["slot_wait_s_sum"]) / n if n and "slot_wait_s_sum" in a else None
