"""Set-up seconds: process start to the window's first request (loading,
weights, warm-up of every shape the traffic reaches, the kernels' build on a
checkout's first run)."""


def read(record):
    return record.setup_s
