"""The engine's mean queue wait of a request over the window (its counters
``wait_s_sum`` over ``requests``), milliseconds."""


def read(record):
    a, b = record.counters["after"]["engine"], record.counters["before"]["engine"]
    n = a["requests"] - b["requests"]
    return 1e3 * (a["wait_s_sum"] - b["wait_s_sum"]) / n if n else None
