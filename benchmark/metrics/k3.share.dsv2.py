"""K3's share of the device's busy time in the traced slice: the routed-
expert kernels' device time by name (``k3_``) over the union of the
device's activity, percent; nothing where no K3 kernel ran."""

K3_KERNELS = ("k3_",)


def read(record):
    t = record.trace
    if t is None or t.busy_s <= 0:
        return None
    k3_s = t.kernel_s(*K3_KERNELS)
    return 100.0 * k3_s / t.busy_s if k3_s > 0 else None
