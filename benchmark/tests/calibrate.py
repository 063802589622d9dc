"""Readings of the correctness check on the card, for setting its limits:
the program as configured and the control (the reference computed in fp8
in the program's place), each on several seeds, in one process per cell.

    python3 benchmark/tests/calibrate.py --workload <cell> --seconds 4 \\
        --seeds 11,12,13 [--control-seeds 21,22,23]

Prints one JSON line per run: the seed, the variant, the compared numbers
and every reading the cell's driver module (``drivers/``) took.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    from benchmark import harness

    cell = harness.Cell(ROOT, args.workload)
    harness.setup_env(ROOT)
    import torch

    run = harness.load_file(os.path.join(ROOT, "benchmark", "run.py"))
    device = torch.device("cuda", 0) if torch.cuda.is_available() else \
        torch.device("cpu")
    jobs = [(int(s), None) for s in args.seeds.split(",") if s]
    jobs += [(int(s), "fp8")
             for s in args.control_seeds.split(",") if s]
    for seed, control in jobs:
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory(prefix="zipvoice_cal_") as tmp:
            ctx = run.Context(cell=cell, seed=seed, seconds=args.seconds,
                              trace=False, control=control, torch=torch,
                              device=device, tmpdir=tmp,
                              t_start=time.monotonic())
            out = cell.driver().run(ctx)
        print(json.dumps({"seed": seed, "control": control,
                          "correct": out["correct"],
                          "run_s": time.monotonic() - t0,
                          "checks": {c["name"]: c["value"]
                                     for c in out["checks"]},
                          "readings": out["readings"]}), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
