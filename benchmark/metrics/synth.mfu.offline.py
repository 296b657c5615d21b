"""The whole synthesis step's share of the card's peak over the traced
batches: the algorithm's products of those batches (encoder, alignment,
the CFM's U-Net steps, HiFi-GAN, the denoiser) over the traced time at the
float32 bound of 495 TFLOP/s, percent."""

from benchmark import work
from benchmark.drivers.offline import work_of


def read(record):
    t = record.trace
    if t is None or not t.work:
        return None
    flops = sum(work_of(record.extra["config"], item).flops for item in t.work)
    return 100.0 * flops / (t.window_s * work.TF32_FLOPS)
