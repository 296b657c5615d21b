"""The 95th percentile over every request due in the window of the time from
when it was due to its audio on the host (milliseconds).  A request that
failed or never came counts at the wait ``drivers/serve.py`` gave it."""

import numpy as np

from benchmark.drivers.serve import WAIT_S


def read(record):
    lat = [r["latency_s"] if r.get("latency_s") is not None and not r.get("error") else WAIT_S
           for r in record.items]
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
