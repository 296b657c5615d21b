"""The pipeline's CFM decode stage (its ``stage_ms["decoder"]``, CUDA
events), mean per dispatched batch of the window, milliseconds."""


def read(record):
    seen = {}
    for r in record.items:
        ms = r.get("stage_ms")
        if ms is not None and "decoder" in ms:
            seen[id(ms)] = ms["decoder"]
    return sum(seen.values()) / len(seen) if seen else None
