"""Whisper's transcription, host clock around ``transcribe`` (its ids end on
the host), mean per turn, milliseconds."""


def read(record):
    turns = record.items
    return 1e3 * sum(t["asr_s"] for t in turns) / len(turns) if turns else None
