"""Process start to the window's start: imports, weights drawn on the card,
the kernels' build on a checkout's first run, warm-up (host clock)."""


def read(rec):
    return rec.get("setup_s")
