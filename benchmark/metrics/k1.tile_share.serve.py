"""The share of the padded call's vocoder frames that K1 computes over the
window: the engine's counters ``k1_frames_live_sum`` (each live row's reach
at the mel rate) over ``k1_frames_all_sum`` (batch bucket × mel bucket, per
batch), percent; nothing where the engine keeps no such counter."""


def read(record):
    a, b = record.counters["after"]["engine"], record.counters["before"]["engine"]
    if "k1_frames_all_sum" not in a:
        return None
    every = a["k1_frames_all_sum"] - b["k1_frames_all_sum"]
    return 100.0 * (a["k1_frames_live_sum"] - b["k1_frames_live_sum"]) / every if every else None
