#!/usr/bin/env python3
"""Read the offline pipeline's spans and counters (``zipvoice_torch/utils/
trace.py``) in a run of the benchmark's ``zipvoice.longform`` cell, or at
one batch shape.

    python3 torch_trace_probe.py cell --seed N [--seconds 51] [--trace 0|1]
    python3 torch_trace_probe.py batch [--rows 4] [--frames 2560]

``cell`` runs ``benchmark/run.py`` in this process with tracing on from the
start (the benchmark leaves it off) and prints, after the run's result
line, one line of what the spans give:

- ``host_gap_share``: the window's unprofiled calls' ``drained_s`` over
  their part of the window (the calls after the warm-up one, up to the
  profiler's start), in %: the host time in which the card had nothing
  queued, without the profiler's cost;
- ``enqueue_share``: the same calls' host seconds in ``zv.sample.enqueue``
  over its device seconds, in %: near 100 the host's launches pace the
  sampling, well under it the card does;
- with ``--trace 1``, from the profiler's trace of the window's last
  seconds: ``launches_per_step`` (the ``cuda_runtime`` kernel launches
  that start inside a ``zv.step`` annotation, over the annotations) and
  ``idle_gaps``, the slice's ten longest device-idle gaps, each with the
  ``zv.*`` spans that overlap it and the overlap in ms, and the part no
  span covers as "between calls".

``batch`` builds the cell's model and vocoder with seeded weights on the
card and samples one batch of ``--rows`` rows whose frames fill the
``--frames`` bucket, a few times, each as a traced call of its own, and
prints each one's enqueue share.  Needs a CUDA card.
"""

import argparse
import bisect
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CELL = "zipvoice.longform"


def step_launches(events):
    """(kernel launches inside ``zv.step`` annotations, annotations) in a
    chrome trace's events."""
    steps = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == "zv.step")
    starts = [a for a, _ in steps]
    n = 0
    for e in events:
        if e.get("cat") != "cuda_runtime" or "LaunchKernel" not in e.get(
                "name", ""):
            continue
        ts = float(e["ts"])
        i = bisect.bisect_right(starts, ts) - 1
        n += i >= 0 and ts < steps[i][1]
    return n, len(steps)


def idle_gaps_by_span(events, top=10):
    """The ``top`` longest intervals of the ``bench_slice`` annotation in
    which no device operation ran, longest first: [gap ms, its start in ms
    from the slice's, {span: overlap ms}] with every ``zv.*`` span that
    overlaps it, and as "between calls" the part that no span covers (the
    harness's time between calls, and the microseconds between a call's
    spans)."""
    from benchmark.harness import DEVICE_CATS

    mark = [e for e in events if e.get("name") == "bench_slice"
            and e.get("cat") == "user_annotation"]
    if not mark:
        return []
    s0 = float(mark[0]["ts"])
    s1 = s0 + float(mark[0]["dur"])
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in events if e.get("cat") in DEVICE_CATS)
    gaps, edge = [], s0
    for a, b in dev:
        if b <= s0 or a >= s1:
            continue
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if edge < s1:
        gaps.append((edge, s1))
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith("zv.")]
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        over, clipped = {}, []
        for c, d, name in spans:
            if min(b, d) > max(a, c):
                over[name] = (over.get(name, 0.0)
                              + (min(b, d) - max(a, c)) * 1e-3)
                clipped.append((max(a, c), min(b, d)))
        covered, edge = 0.0, a
        for c, d in sorted(clipped):
            covered += max(0.0, d - max(c, edge))
            edge = max(edge, d)
        if b - a - covered > 0:
            over["between calls"] = (b - a - covered) * 1e-3
        out.append([(b - a) * 1e-3, (a - s0) * 1e-3, over])
    return out


def cell(args, root: str = REPO, workload: str = CELL,
         allow_cpu: bool = False) -> int:
    """``cell`` on ``workload`` of the checkout at ``root`` (on the CPU
    where ``allow_cpu``: a rehearsal on the benchmark's toy cells)."""
    sys.path.insert(0, REPO)
    from benchmark import harness

    calls, profiled, read = [], {}, {}

    def recorded(generate):
        def call(self, *a, **kw):
            t0 = time.monotonic()
            wav, m = generate(self, *a, **kw)
            calls.append((t0, time.monotonic(), m.get("trace")))
            return wav, m
        return call

    pin_cpus = harness.pin_cpus

    def pinned(*a):
        # the port (and torch) load here, after the run has pinned its
        # CPUs and before it imports torch, as in a plain run
        keep = pin_cpus(*a)
        from zipvoice_torch.infer.pipeline import InferencePipeline
        from zipvoice_torch.utils import trace

        InferencePipeline.generate_sentence = recorded(
            InferencePipeline.generate_sentence)
        trace.enable(True)
        return keep

    start = harness.Profiled.start

    def started(self):
        profiled["at"] = start(self)
        return profiled["at"]

    summarize = harness.summarize_trace

    def summarized(path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        read["launches"], read["steps"] = step_launches(events)
        read["idle_gaps"] = idle_gaps_by_span(events)
        return summarize(path)

    harness.pin_cpus = pinned
    harness.Profiled.start = started
    harness.summarize_trace = summarized
    run = harness.load_file(os.path.join(root, "benchmark", "run.py"))
    rc = run.main(["--workload", workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace",
                   str(args.trace)], allow_cpu=allow_cpu)
    if rc != 0:
        return rc
    # the first call is the warm-up's; the window's unprofiled part ends
    # where the profiler started
    window = calls[1:]
    t_end = profiled.get("at", window[-1][1])
    plain = [c for c in window if c[1] <= t_end and c[2]]
    line = {"calls": len(window), "plain_calls": len(plain)}
    if plain:
        host = sum(c[2]["spans"]["zv.sample.enqueue"]["s"] for c in plain)
        dev = sum(c[2]["device_s"]["zv.sample.enqueue"] for c in plain)
        line["host_gap_share"] = 100.0 * sum(
            c[2]["counters"]["drained_s"] for c in plain) / (
            t_end - window[0][0])
        line["enqueue_share"] = 100.0 * host / dev
        line["per_call"] = [{k: c[2][k] for k in ("spans", "device_s",
                                                  "counters")}
                            | {"wall_s": c[1] - c[0]} for c in plain[:3]]
    if read.get("steps"):
        line["launches_per_step"] = read["launches"] / read["steps"]
        line["idle_gaps"] = read["idle_gaps"]
    for gap_ms, at_ms, over in read.get("idle_gaps", []):
        parts = ", ".join(f"{k} {v:.1f}" for k, v in over.items())
        print(f"idle gap {gap_ms:.1f} ms at {at_ms:.1f} ms: {parts}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def batch(args) -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    from benchmark import traffic_gen as tg
    from benchmark.drivers.program import build_pipeline, build_weights
    from benchmark.harness import Cell
    from benchmark.reference import frontend as fe
    from zipvoice_torch.utils import trace

    if not torch.cuda.is_available():
        print("batch needs a CUDA card", file=sys.stderr)
        return 2
    c = Cell(REPO, CELL)
    inf = c.config["inference"]
    device = torch.device("cuda", 0)
    P, V = build_weights(c.config, 1, device)
    pipe = build_pipeline(c.config, P, V, device)
    pr = tg.prompts(tg.Corpus(), c.traffic["prompts"])[0]
    feats, _, _ = fe.prepare_prompt(pr["wav"], inf["feat_scale"],
                                    inf["target_rms"])
    pfl, ptl = feats.shape[0], len(pr["phones"])
    # text tokens whose predicted frames fall just under the bucket
    n = int((args.frames - 60 - pfl) * ptl / pfl)
    rng = np.random.RandomState(0)
    rows = [list(rng.randint(1, 300, n)) for _ in range(args.rows)]
    prompt = list(rng.randint(1, 300, ptl))
    trace.enable(True)
    out = []
    for i in range(args.repeats + 1):
        trace.begin(time.perf_counter())
        x, lens = pipe._sample_batch(
            rows, prompt, feats, num_step=inf["num_step"],
            guidance_scale=inf["guidance_scale"], speed=1.0,
            t_shift=inf["t_shift"])
        rec = trace.finish(time.perf_counter())
        if i:  # the first call warms the shapes
            host = rec["spans"]["zv.sample.enqueue"]["s"]
            dev = rec["device_s"]["zv.sample.enqueue"]
            out.append({"enqueue_s": host, "device_s": dev,
                        "enqueue_share": 100.0 * host / dev})
    print(json.dumps({"rows": args.rows, "shape": list(x.shape),
                      "card": torch.cuda.get_device_name(0),
                      "repeats": out}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    c = sub.add_parser("cell")
    c.add_argument("--seed", type=int, required=True)
    c.add_argument("--seconds", type=float, default=51)
    c.add_argument("--trace", type=int, choices=(0, 1), default=1)
    b = sub.add_parser("batch")
    b.add_argument("--rows", type=int, default=4)
    b.add_argument("--frames", type=int, default=2560)
    b.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    return cell(args) if args.mode == "cell" else batch(args)


if __name__ == "__main__":
    sys.exit(main())
