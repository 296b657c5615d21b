"""The engine's collection window, from the worker's first request of a
batch to the batch's close, mean per dispatched batch over the window (the
engine's counters ``collect_s_sum`` over ``batches``), milliseconds; nothing
where the engine keeps no such counter."""


def read(record):
    a, b = record.counters["after"]["engine"], record.counters["before"]["engine"]
    n = a["batches"] - b["batches"]
    return 1e3 * (a["collect_s_sum"] - b["collect_s_sum"]) / n if n and "collect_s_sum" in a else None
