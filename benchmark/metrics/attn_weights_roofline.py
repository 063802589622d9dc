"""Kernel #1's share of its roofline: the least time the H100 could take
for the launches in the profiled slice (``counts/traffic.py``'s
``attention_traffic`` at each launch's shape) over their device time.

Matched CUDA kernels: ``rel_pos_mma_kernel`` (the bf16 build; the query
rows of a block, 64, and B x heads are its grid's x and y)."""

from benchmark.counts.traffic import attention_traffic, bound

KERNELS = ("rel_pos_mma_kernel",)
ROWS_PER_BLOCK = 64


def read(rec):
    trace = rec.get("trace")
    if not trace:
        return None
    h, qd, pd = rec["attn"]["h"], rec["attn"]["qd"], rec["attn"]["pd"]
    least, spent = 0.0, 0.0
    for name, seconds, grid in trace["kernels"]:
        if not any(k in name for k in KERNELS) or "true>" in name:
            continue
        T = ROWS_PER_BLOCK * grid[0]
        B = grid[1] // h
        least += bound(*attention_traffic(B, h, T, qd, pd))[0] * 1e-3
        spent += seconds
    return 100.0 * least / spent if spent > 0 else None
