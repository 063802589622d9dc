"""Seconds of 24 kHz audio returned over the window's wall seconds (host
clock); only what completed inside the window counts."""


def read(rec):
    if rec.get("window_s", 0) <= 0 or rec.get("audio_s", 0) <= 0:
        return None
    return rec["audio_s"] / rec["window_s"]
