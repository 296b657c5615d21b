"""The pipeline's host read of the predicted mel length, which waits for
everything enqueued before it (an earlier batch's work included), mean per
dispatched batch over the window (the engine's counters ``host_read_s_sum``
over ``batches``), milliseconds; nothing where the engine keeps no such
counter."""


def read(record):
    a, b = record.counters["after"]["engine"], record.counters["before"]["engine"]
    n = a["batches"] - b["batches"]
    return 1e3 * (a["host_read_s_sum"] - b["host_read_s_sum"]) / n if n and "host_read_s_sum" in a else None
