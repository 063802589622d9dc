"""The profiled slice's seconds in which no operation ran on the device,
over the slice (device trace)."""


def read(rec):
    trace = rec.get("trace")
    if not trace or trace.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
