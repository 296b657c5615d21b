"""K1's share of its roofline over the traced batches: the least time the
card could take for the MRF stages' work (the algorithm's products at the
float32 bound of 495 TFLOP/s, or its bytes at 3.35 TB/s, whichever is
larger) over K1's device time by kernel name, percent."""

from benchmark import work

K1_KERNELS = ("conv_taps_kernel",)


def read(record):
    t = record.trace
    if t is None or not t.work:
        return None
    k1_s = t.kernel_s(*K1_KERNELS)
    if k1_s <= 0:
        return None
    voc = record.extra["config"]["vocoder"]
    bound = sum(c.bound_s() for item in t.work for c in work.k1_calls(voc, item["batch"], item["m_bucket"]))
    return 100.0 * bound / k1_s
