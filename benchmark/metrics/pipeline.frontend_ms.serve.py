"""The pipeline's text frontend (``encode_texts``, on the engine's worker
thread), mean per dispatched batch over the window (the engine's counters
``frontend_s_sum`` over ``batches``), milliseconds; nothing where the
engine keeps no such counter."""


def read(record):
    a, b = record.counters["after"]["engine"], record.counters["before"]["engine"]
    n = a["batches"] - b["batches"]
    return 1e3 * (a["frontend_s_sum"] - b["frontend_s_sum"]) / n if n and "frontend_s_sum" in a else None
