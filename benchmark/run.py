#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by
their names in ``BENCHMARK.json`` at the checkout's root and in this
folder's ``configs/``, ``traffic/``, ``drivers/`` and ``metrics/``.  Set-up
(loading, weights drawn from the seed on the card, kernels built on a
checkout's first run, warm-up) counts as ``setup_s``; then the window runs
for ``--seconds``; then the plain reference recomputes a sample of what the
window produced and decides ``correct``.  With ``--trace 1`` the window's
last seconds run under ``torch.profiler`` and the line carries the
per-layer metrics instead of the end-to-end ones.

Standard error ends with each compared number beside its limit; the last
line of standard output is the result.  Without a CUDA card, or with fewer
cards than the cell asks for, it exits 2 and prints no result.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class Context:
    """What a driver gets: the cell, the run's arguments, torch and the
    device, a scratch directory in the run's TMPDIR, and the process's
    start."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def main(argv=None, allow_cpu: bool = False, patches=(),
         control=None) -> int:
    """One run.  ``allow_cpu``, the planted faults (``patches``, callables
    run before the program is built) and the correctness check's control
    (``control="fp8"``: the reference computed in fp8 in the program's
    place) are for the benchmark's own tests; the command line has none of
    them."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    cell = harness.Cell(ROOT, args.workload)
    harness.setup_env(ROOT)
    cpus = harness.pin_cpus("upper")
    import torch

    torch.set_num_threads(len(cpus))

    chips = cell.entry["chips"]
    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        device = torch.device("cuda", 0)
    elif allow_cpu:
        device = torch.device("cpu")
    else:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    for patch in patches:
        patch()
    with tempfile.TemporaryDirectory(prefix="zipvoice_bench_") as tmp:
        ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), control=control,
                      torch=torch, device=device, tmpdir=tmp,
                      t_start=T_START)
        out = cell.driver().run(ctx)
    found = harness.forbidden_loaded() + out.get("forbidden", [])
    if found:
        print(f"forbidden modules loaded: {sorted(set(found))}",
              file=sys.stderr)
        return 3
    dev = harness.device_info(torch, device, chips)
    dev["kind"] = out.get("kind", dev["kind"])
    dev["memory_peak_bytes"] = int(out["memory_peak_bytes"])
    if args.trace and out.get("trace"):
        dev["busy_s"] = out["trace"]["busy_s"]
        dev["window_s"] = out["trace"]["window_s"]
    print(f"card: {harness.power_limit() if device.type == 'cuda' else 'cpu'}",
          file=sys.stderr)
    harness.emit(cell, out["rec"], bool(args.trace), dev, out["checks"],
                 out["correct"], out["attempted"], out["failed"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
