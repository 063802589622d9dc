#!/usr/bin/env python3
"""Time this checkout's CUDA kernels against another checkout's, on one card.

    python3 kernel_ab.py --other DIR [--pairs 2] [--seed 0]

DIR is a checkout of another commit (for example a ``git archive`` of the
parent unpacked into ``build/parent``).  The script runs one timing process
per checkout in turns, other, this, this, other, ``--pairs`` times, each
process building its own checkout's kernels into that checkout's
``build/kernels`` and importing only that checkout's ``zipvoice_torch``.  A
process times every kernel wrapper at the main path's shapes (CUDA events,
bf16, the wrappers' public signatures, which both checkouts share): the
inference weights (#1) at B=16, h=4, T in {320, 640, 1280, 2560}, the fused
weights + NonlinAttention kernel (#2) and the application kernel (#3) at
T in {640, 1280}, the training pair (#4, #5) at B=8, T in {640, 1280}, and
the depthwise conv (#6 at B=16, #7 at B=8) at every level of the main path.
Prints, for each kernel and checkout, the middle of its sorted times (the
upper middle for an even count), with the card's name and power limit, and
whether the two checkouts' outputs have the same bits on the same inputs
(each output tensor's digest; #7's dv apart from its dw and db); no result
without a card.

    python3 kernel_ab.py --split [--other DIR]

adds, for the depthwise-conv backward (#7) at every level, each device
kernel's own time per call (``torch.profiler``'s CUDA kernel records, the
calls queued behind a spin of the card), so that a wrapper launching several
kernels shows where its time goes.
"""

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

# imported before the other checkout joins sys.path: this checkout's timer
# and the main path's conv levels
from chip_smoke import CONV_LEVELS, SPIN_CYCLES_PER_CALL, cuda_ms

REPO = os.path.dirname(os.path.abspath(__file__))


def digest(out):
    """The first 16 hex digits of the sha256 of each output tensor's bytes."""
    import torch

    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [hashlib.sha256(t.detach().reshape(-1).view(torch.uint8).cpu()
                           .numpy().tobytes()).hexdigest()[:16]
            for t in outs]


def device_split(fn, iters=50):
    """{device kernel: ms per call of ``fn``}: each CUDA kernel's own time
    from ``torch.profiler``, the calls queued behind a spin of the card
    (whose own record is left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(SPIN_CYCLES_PER_CALL * iters)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us <= 0 or "sleep" in e.key or "spin" in e.key:
            continue
        # "void (anonymous namespace)::dwconv_dw_kernel<T, 31>(...)" ->
        # "dwconv_dw_kernel<T, 31>"
        found = re.search(r"(\w+(?:<[^()]*>)?)\(", e.key)
        name = found.group(1) if found else e.key
        split[name] = split.get(name, 0.0) + us / 1e3 / iters
    if not split:
        raise RuntimeError("torch.profiler recorded no device kernel time")
    return split


def time_checkout(repo, seed, split=False):
    """{"ms": {kernel at shape: ms}, "bits": {kernel at shape: digests},
    "split": {#7 at shape: {device kernel: ms}}} for the kernels of the
    checkout at ``repo``."""
    sys.path.insert(0, repo)
    import torch

    from zipvoice_torch.kernels import depthwise_conv as dc
    from zipvoice_torch.kernels import rel_pos_attention as ra

    g = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16
    bits = {}
    splits = {}

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(bf16)

    def attention_args(B, T, h=4, qd=32, pd=4):
        lens = torch.randint(T // 2, T + 1, (B,), generator=g, device="cuda")
        lens[0] = T
        mask = torch.arange(T, device="cuda")[None, :] >= lens[:, None]
        return (randn(B, h, T, qd), randn(B, h, T, qd),
                randn(B, h, T, pd, scale=0.3), randn(h, 2 * T - 1, pd), mask)

    def timed(fn, name=None):
        if name is not None:
            bits[name] = digest(fn())
        return cuda_ms(fn, iters=50)

    out = {}
    for T in (320, 640, 1280, 2560):
        args = attention_args(16, T)
        name = f"#1 weights B=16 T={T}"
        out[name] = timed(lambda: ra.rel_pos_attention_weights(*args), name)
        if T in (640, 1280):
            nv = randn(16, T, 384)
            name = f"#2 nonlin B=16 T={T}"
            out[name] = timed(
                lambda: ra.rel_pos_attention_weights_nonlin(*args, nv), name)
            w = ra.rel_pos_attention_weights(*args)
            v = randn(16, 4, T, 12)
            name = f"#3 apply B=16 T={T}"
            out[name] = timed(lambda: ra.attention_apply(w, v), name)
            del nv, w, v
        del args
        torch.cuda.empty_cache()
    for T in (640, 1280):
        q, k, p, pe, mask = attention_args(8, T)
        name = f"#4 train B=8 T={T}"
        out[name] = timed(
            lambda: ra.rel_pos_attention_weights_train(q, k, p, pe, mask),
            name)
        w, _ = ra.rel_pos_attention_weights_train(q, k, p, pe, mask)
        gw = randn(*w.shape)
        coin = torch.zeros((), device="cuda")
        name = f"#5 bwd B=8 T={T}"
        out[name] = timed(
            lambda: ra.rel_pos_attention_weights_bwd(q, k, p, pe, gw, w,
                                                     coin), name)
        del q, k, p, pe, mask, w, gw
        torch.cuda.empty_cache()
    for C, T, kk in CONV_LEVELS:
        lim = kk ** -0.5
        wt = ((2 * torch.rand(C, kk, generator=g, device="cuda") - 1)
              * lim).to(bf16)
        b = ((2 * torch.rand(C, generator=g, device="cuda") - 1)
             * lim).to(bf16)
        v = randn(16, T, C)
        name = f"#6 conv B=16 C={C} T={T} k={kk}"
        out[name] = timed(lambda: dc.depthwise_conv1d(v, wt, b), name)
        vt, gt = v[:8].contiguous(), randn(8, T, C)
        name = f"#7 conv bwd B=8 C={C} T={T} k={kk}"
        out[name] = timed(lambda: dc.depthwise_conv1d_bwd(vt, gt, wt))
        dv, dw, db = dc.depthwise_conv1d_bwd(vt, gt, wt)
        bits[f"{name} dv"] = digest(dv)
        bits[f"{name} dw, db"] = digest((dw, db))
        if split:
            splits[name] = device_split(
                lambda: dc.depthwise_conv1d_bwd(vt, gt, wt))
    return {"ms": out, "bits": bits, "split": splits}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--split", action="store_true",
                    help="add each device kernel's time of #7 at each level")
    ap.add_argument("--time-only", metavar="DIR",
                    help="time the checkout at DIR and print JSON (one turn)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    if args.time_only:
        print(json.dumps(time_checkout(os.path.abspath(args.time_only),
                                       args.seed, args.split)))
        return 0
    sys.path.insert(0, REPO)
    from zipvoice_torch.infer.workload import card_identity

    card = card_identity()
    sides = {"this": REPO}
    order = ("this",)
    if args.other:
        sides["other"] = os.path.abspath(args.other)
        order = ("other", "this", "this", "other")
    runs = {side: [] for side in sides}
    for _ in range(args.pairs):
        for side in order:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--seed",
                 str(args.seed), "--time-only", sides[side]]
                + ["--split"] * args.split,
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"timing {sides[side]} failed:\n"
                                   f"{res.stderr[-4000:]}")
            runs[side].append(json.loads(res.stdout.strip().splitlines()[-1]))

    def middle(side, key, name, sub=None):
        xs = sorted(r[key][name] if sub is None else r[key][name].get(sub, 0.0)
                    for r in runs.get(side, ()) if name in r[key])
        return xs[len(xs) // 2] if xs else float("nan")

    n = len(order) * args.pairs // len(sides)
    print(f"kernel A/B, {n} process(es) a side in the order "
          f"{', '.join(order)}; middle times in ms [{card}]")
    print(f"{'kernel':40s} {'other':>9s} {'this':>9s} {'this/other':>10s}")
    for name in runs["this"][0]["ms"]:
        o, t = middle("other", "ms", name), middle("this", "ms", name)
        print(f"{name:40s} {o:9.4f} {t:9.4f} {t / o:10.3f}", flush=True)
    if "other" in runs:
        print("same output bits as the other checkout (first process a "
              "side, same seed):")
        for name, mine in runs["this"][0]["bits"].items():
            theirs = runs["other"][0]["bits"].get(name)
            print(f"  {name}: {'equal' if mine == theirs else 'differ'}")
    for side in sides:
        for name, first in runs[side][0]["split"].items():
            parts = ", ".join(f"{k} {middle(side, 'split', name, k):.4f}"
                              for k in first)
            print(f"device kernels of {name} ({side}): {parts}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
