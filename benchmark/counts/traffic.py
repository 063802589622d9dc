"""Bytes, operations and the least time of the port's kernels on an H100.

Frozen copies of ``chip_smoke.py``'s ``attention_traffic``, ``bwd_traffic``
and ``bound`` and of its peaks, so that a later change to the program cannot
move the yardstick.  Each input is counted as read once and each output as
written once; the bound is the larger of the bytes over the HBM rate and the
operations over the dense bf16 tensor rate.
"""

# NVIDIA H100 SXM data sheet: HBM3 rate and dense (no sparsity) bf16 rate,
# both at the card's full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# query rows per block of the bf16 weights kernels; the training build
# writes one f32 |score| maximum per block
ROWS_PER_BLOCK = 64


def bound(bytes_moved, flops):
    """(bound ms, what bounds it): the larger of the bytes over the HBM rate
    and the operations over the bf16 tensor rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_traffic(B, h, T, qd, pd, train=False):
    """(bytes, operations) of the attention-weights kernel in bf16: q, k, p
    (B, h, T, d), pe (h, 2T-1, pd) and the (B, T) byte mask read once, the
    (B, h, T, T) weights written once (and, for the training build, its
    per-block maxima), against the q.k + p.pe multiply-adds."""
    bytes_moved = (2 * (2 * B * h * T * qd + B * h * T * pd
                        + h * (2 * T - 1) * pd)
                   + B * T + 2 * B * h * T * T)
    if train:
        bytes_moved += 4 * B * h * -(-T // ROWS_PER_BLOCK)
    return bytes_moved, B * h * T * T * (2 * qd + 2 * pd)


def bwd_traffic(B, h, T, qd, pd, itemsize, penalty):
    """(bytes, operations) of the attention-weights backward: g and w read
    once and q, k, p, pe once, dq, dk, dp, dpe written once in f32; its
    multiply-adds (row sums, ds, dq, dk, dp, dpe, and the score recompute
    when the penalty is live)."""
    bytes_moved = (2 * B * h * T * T * itemsize
                   + itemsize * (2 * B * h * T * qd + B * h * T * pd
                                 + h * (2 * T - 1) * pd)
                   + 4 * (2 * B * h * T * qd + B * h * T * pd
                          + h * (2 * T - 1) * pd))
    per_weight = 4 * qd + 4 * pd + 6 + (2 * qd + 2 * pd if penalty else 0)
    return bytes_moved, B * h * T * T * per_weight
