#!/usr/bin/env python3
"""Where the time of one main-path request goes in the PyTorch port, on a GPU.

    python3 torch_main_path_probe.py [--rounds 3] [--seed 0] [--kernel-config]

Builds the full-width ZipVoice base model and Vocos (bf16, random weights
from ``--seed``, as chip_smoke.py does) and runs the B=8, T=1280 request
(3 s prompts, 100-token texts, 16 steps, CFG 1.0):

1. an A/B of the attention-weights kernel against the plain skew path (with
   ``--kernel-config``: of the kernel configuration, every kernel switch
   on, against the default configuration), in the order plain, kernel,
   kernel, plain per round, on one card;
2. one kernel request under ``torch.profiler`` (with ``--kernel-config``
   one in each configuration): device time by kernel, the device's busy
   share of that request's wall time (the profiler's own host cost
   included), and the shares taken by the port's kernels.

Every time line carries the card's name and power limit.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def profile_request(pipe, req, name, card):
    """One request under torch.profiler: its wall, the device's busy time,
    the port's kernels' shares and the largest device kernels."""
    import torch

    from zipvoice_torch.infer.workload import run_request

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_request(pipe, req, 16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total_us = sum(e.self_device_time_total for e in events)

    def share(*words):
        mine = [e for e in events if any(w in e.key for w in words)]
        us = sum(e.self_device_time_total for e in mine)
        n = sum(e.count for e in mine)
        pct = 100 * us / max(total_us, 1)
        return f"{us / 1e3:.2f} ms, {n} calls ({pct:.1f}%)"

    print(f"profiled {name} request: wall {wall:.4f} s, device busy "
          f"{total_us / 1e6:.4f} s ({100 * total_us / 1e6 / wall:.1f}% of "
          f"this profiled wall), {sum(e.count for e in events)} device "
          f"kernels; rel-pos attention kernel "
          f"{share('rel_pos_mma_kernel', 'rel_pos_weights_kernel')}, fused "
          f"weights + NonlinAttention kernel {share('nonlin_')}, application "
          f"kernel {share('attn_apply')}, conv kernel "
          f"{share('dwconv_kernel')}, PyTorch depthwise conv "
          f"{share('depthwise')} [{card}]", flush=True)
    print("top device kernels (self device time):")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:6d} calls  {e.key[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-config", action="store_true",
                    help="A/B the kernel configuration against the default")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.infer.workload import (
        build_base,
        card_identity,
        micro_batches,
        run_request,
    )
    from zipvoice_torch.models.zipformer import (
        set_attention_kernel,
        set_kernel_config,
    )

    card = card_identity()
    model, vocos = build_base(args.seed, torch.bfloat16)
    pipe = InferencePipeline(model, vocos, seed=args.seed)
    req = micro_batches(model.feat_dim, args.seed)[-1]

    def configure(on):
        if args.kernel_config:
            set_kernel_config(model, on)
        else:
            set_attention_kernel(model, on)

    def timed(on):
        configure(on)
        torch.cuda.synchronize()
        t = time.perf_counter()
        run_request(pipe, req, 16)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    timed(True)
    timed(False)  # first touch of both paths
    walls = {True: [], False: []}
    for _ in range(args.rounds):
        for on in (False, True, True, False):
            walls[on].append(timed(on))
    names = (("default configuration", "kernel configuration")
             if args.kernel_config else ("plain skew path", "kernel"))
    for on, name in zip((False, True), names):
        w = sorted(walls[on])
        print(f"B=8 T=1280 request, 16 steps + vocoder, {name}: walls "
              f"{', '.join(f'{x:.4f}' for x in walls[on])} s, median "
              f"{w[len(w) // 2]:.4f} s [{card}]", flush=True)

    # with --kernel-config both configurations, so that their device times
    # come from one card and one call
    for on in (False, True) if args.kernel_config else (True,):
        configure(on)
        profile_request(pipe, req, names[on], card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
