"""Seconds of audio delivered to the host over the window's seconds: every
batch of the window, and the time to the end of its last batch."""


def read(record):
    batches = record.items
    if not batches:
        return None
    return sum(b["audio_s"] for b in batches) / batches[-1]["t1"]
