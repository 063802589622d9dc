"""Padded row-frames over all row-frames sampled: each sample call's
bucketed batch times its frame bucket against its real rows' frames,
recorded around the call, over the window's unprofiled part."""


def read(rec):
    calls = rec.get("sample_calls")
    if not calls:
        return None
    total = sum(c["B"] * c["T"] for c in calls)
    real = sum(sum(c["fl"]) for c in calls)
    return 100.0 * (total - real) / total
