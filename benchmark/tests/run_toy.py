"""One run of a cell of a toy checkout on the CPU, in a process of its own,
with a planted fault or the control: the benchmark's tests start it.

    python benchmark/tests/run_toy.py <checkout> <workload> <seed> \\
        <seconds> <trace> [--fault NAME] [--control fp8]
"""

import argparse
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root")
    ap.add_argument("workload")
    ap.add_argument("seed")
    ap.add_argument("seconds")
    ap.add_argument("trace")
    ap.add_argument("--fault")
    ap.add_argument("--control", choices=("fp8",))
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    from benchmark import harness
    from benchmark.tests import faults

    run = harness.load_file(os.path.join(args.root, "benchmark", "run.py"))
    argv = ["--workload", args.workload, "--seed", args.seed, "--seconds",
            args.seconds, "--trace", args.trace]
    patches = [getattr(faults, args.fault)] if args.fault else []
    return run.main(argv, allow_cpu=True, patches=patches,
                    control=args.control)


if __name__ == "__main__":
    sys.exit(main())
