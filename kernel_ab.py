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
upper middle for an even count), with the card's name and power limit; no
result without a card.
"""

import argparse
import json
import os
import subprocess
import sys

# imported before the other checkout joins sys.path: this checkout's timer
# and the main path's conv levels
from chip_smoke import CONV_LEVELS, cuda_ms

REPO = os.path.dirname(os.path.abspath(__file__))


def time_checkout(repo, seed):
    """{kernel at shape: ms} for the kernels of the checkout at ``repo``."""
    sys.path.insert(0, repo)
    import torch

    from zipvoice_torch.kernels import depthwise_conv as dc
    from zipvoice_torch.kernels import rel_pos_attention as ra

    g = torch.Generator(device="cuda").manual_seed(seed)
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")).to(bf16)

    def attention_args(B, T, h=4, qd=32, pd=4):
        lens = torch.randint(T // 2, T + 1, (B,), generator=g, device="cuda")
        lens[0] = T
        mask = torch.arange(T, device="cuda")[None, :] >= lens[:, None]
        return (randn(B, h, T, qd), randn(B, h, T, qd),
                randn(B, h, T, pd, scale=0.3), randn(h, 2 * T - 1, pd), mask)

    def timed(fn):
        return cuda_ms(fn, iters=50)

    out = {}
    for T in (320, 640, 1280, 2560):
        args = attention_args(16, T)
        out[f"#1 weights B=16 T={T}"] = timed(
            lambda: ra.rel_pos_attention_weights(*args))
        if T in (640, 1280):
            nv = randn(16, T, 384)
            out[f"#2 nonlin B=16 T={T}"] = timed(
                lambda: ra.rel_pos_attention_weights_nonlin(*args, nv))
            w = ra.rel_pos_attention_weights(*args)
            v = randn(16, 4, T, 12)
            out[f"#3 apply B=16 T={T}"] = timed(
                lambda: ra.attention_apply(w, v))
            del nv, w, v
        del args
        torch.cuda.empty_cache()
    for T in (640, 1280):
        q, k, p, pe, mask = attention_args(8, T)
        out[f"#4 train B=8 T={T}"] = timed(
            lambda: ra.rel_pos_attention_weights_train(q, k, p, pe, mask))
        w, _ = ra.rel_pos_attention_weights_train(q, k, p, pe, mask)
        gw = randn(*w.shape)
        coin = torch.zeros((), device="cuda")
        out[f"#5 bwd B=8 T={T}"] = timed(
            lambda: ra.rel_pos_attention_weights_bwd(q, k, p, pe, gw, w,
                                                     coin))
        del q, k, p, pe, mask, w, gw
        torch.cuda.empty_cache()
    for C, T, kk in CONV_LEVELS:
        lim = kk ** -0.5
        wt = ((2 * torch.rand(C, kk, generator=g, device="cuda") - 1)
              * lim).to(bf16)
        b = ((2 * torch.rand(C, generator=g, device="cuda") - 1)
             * lim).to(bf16)
        v = randn(16, T, C)
        out[f"#6 conv B=16 C={C} T={T} k={kk}"] = timed(
            lambda: dc.depthwise_conv1d(v, wt, b))
        vt, gt = v[:8].contiguous(), randn(8, T, C)
        out[f"#7 conv bwd B=8 C={C} T={T} k={kk}"] = timed(
            lambda: dc.depthwise_conv1d_bwd(vt, gt, wt))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-only", metavar="DIR",
                    help="time the checkout at DIR and print JSON (one turn)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available", file=sys.stderr)
        return 1
    if args.time_only:
        print(json.dumps(time_checkout(os.path.abspath(args.time_only),
                                       args.seed)))
        return 0
    if not args.other:
        ap.error("--other is required")
    sys.path.insert(0, REPO)
    from zipvoice_torch.infer.workload import card_identity

    card = card_identity()
    sides = {"other": os.path.abspath(args.other), "this": REPO}
    runs = {"other": [], "this": []}
    for _ in range(args.pairs):
        for side in ("other", "this", "this", "other"):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--seed",
                 str(args.seed), "--time-only", sides[side]],
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"timing {sides[side]} failed:\n"
                                   f"{res.stderr[-4000:]}")
            runs[side].append(json.loads(res.stdout.strip().splitlines()[-1]))
    print(f"kernel A/B, {2 * args.pairs} processes a side in the order "
          f"other, this, this, other; middle times in ms [{card}]")
    print(f"{'kernel':40s} {'other':>9s} {'this':>9s} {'this/other':>10s}")
    for name in runs["this"][0]:
        med = {}
        for side, rs in runs.items():
            xs = sorted(r[name] for r in rs if name in r)
            med[side] = xs[len(xs) // 2] if xs else float("nan")
        print(f"{name:40s} {med['other']:9.4f} {med['this']:9.4f} "
              f"{med['this'] / med['other']:10.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
