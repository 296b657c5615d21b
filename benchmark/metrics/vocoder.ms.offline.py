"""The pipeline's vocoder stage (its ``stage_ms["vocoder"]``, CUDA events;
K1 on every MRF stage), mean per batch, milliseconds."""


def read(record):
    ms = [b["stage_ms"]["vocoder"] for b in record.items if "vocoder" in b.get("stage_ms", {})]
    return sum(ms) / len(ms) if ms else None
