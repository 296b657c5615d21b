"""The mean over every turn of the window of the time from the end of the
user's recording (the call to ``transcribe``) to the first chunk of the
reply's audio at the sink (milliseconds)."""


def read(record):
    turns = record.items
    return 1e3 * sum(t["first_audio_s"] for t in turns) / len(turns) if turns else None
