"""The operations that the work completed in the window's unprofiled part
needs (``counts/flops.py``: the text encoder, the fm_decoder at every level
for every step and every row the algorithm runs, Vocos; at real, unpadded
lengths) over that part's wall seconds and the H100's dense bf16 peak."""

from benchmark.counts.traffic import BF16_FLOP_PER_S


def read(rec):
    if rec.get("plain_window_s", 0) <= 0 or not rec.get("flops"):
        return None
    return 100.0 * rec["flops"] / (rec["plain_window_s"] * BF16_FLOP_PER_S)
