"""CUDA graphs the pipeline's graph store captured during the window (its
counter ``captures``): a key the warm-up missed."""


def read(record):
    return record.counters["after"]["graphs"]["captures"] - record.counters["before"]["graphs"]["captures"]
