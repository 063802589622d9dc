#!/usr/bin/env python3
"""Where the time of one full-width training step goes in the PyTorch port.

    python3 torch_train_probe.py [--rounds 4] [--seed 0] [--kernel-config]
    python3 torch_train_probe.py --cli [--seed 0]

Builds the training workload of ``zipvoice_torch/train/workload.py`` (the
ZipVoice base, f32 parameters, bf16 compute, ScaledAdam + Eden with
clipping, schedules and scheduled dropout on, B=8, S=128, T=1280) and:

1. times steps with the trainable attention kernels and with the plain
   skew path (with ``--kernel-config``: with the kernel configuration,
   the conv pair beside the attention pair, and with the default one), in
   the order plain, kernel, kernel, plain in even rounds and
   kernel, plain, plain, kernel in odd ones: ScaledAdam's size update
   (every 4th step, a few hundred extra launches) then falls as often on
   either path over an even number of rounds;
2. splits kernel steps into loss (forward), backward and optimizer wall
   time, each closed by a synchronize;
3. profiles one kernel step under ``torch.profiler``: the device's busy
   share of its wall time and device time by kernel.

With ``--cli`` it times the trainer's entry point instead:
``bin/train_zipvoice`` at the same widths for one epoch of a synthetic
corpus (``CLI_UTTS`` utterances of 12.4-13.5 s through
``bin/prepare_dataset`` and ``bin/compute_fbank``, so every batch is B=8,
T=1280, as in ``chip_smoke.py``'s phase 14), traced by its own
``--profile-dir`` (batches 10-14).  It prints each step's wall and
frames/s, and the device's busy time a step from the trace beside the
median wall of the steps outside it (the profiler's host recording slows
the traced steps themselves).

Every time line carries the card's name and power limit.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# device kernel names of the trainable attention pair (both CUDA sources):
# the bf16 builds the step runs, and the f32 builds
ATTENTION_KERNELS = ("rel_pos_mma_kernel", "bwd_rows_mma_kernel",
                     "bwd_keys_mma_kernel", "bwd_fold_mma_kernel",
                     "rel_pos_weights_kernel", "bwd_rows_kernel",
                     "bwd_keys_kernel", "bwd_fold_kernel")
# the port's depthwise-conv pair and PyTorch's own depthwise kernels
CONV_KERNELS = ("dwconv_", "depthwise", "conv_depthwise")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernel-config", action="store_true",
                    help="A/B the kernel configuration against the default")
    ap.add_argument("--cli", action="store_true",
                    help="time bin/train_zipvoice's steps instead")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    if args.cli:
        return train_cli(args.seed)
    from zipvoice_torch.infer.workload import card_identity
    from zipvoice_torch.models.zipformer import (
        set_attention_kernel,
        set_conv_kernel,
    )
    from zipvoice_torch.ops.schedule import adjusted_batch_count
    from zipvoice_torch.train.train_step import draw_inputs
    from zipvoice_torch.train.workload import build_trainer, train_batch

    card = card_identity()
    model, opt, step = build_trainer(args.seed)
    batch = train_batch(args.seed)
    frames = int(batch["features_lens"].sum())

    def configure(on):
        if args.kernel_config:
            set_conv_kernel(model, on)  # the attention pair stays on
        else:
            set_attention_kernel(model, on)

    def timed(on):
        configure(on)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    for on in (True, False, True, False):  # first touch of both paths
        timed(on)
    walls = {True: [], False: []}
    for r in range(args.rounds):
        for on in ((False, True, True, False) if r % 2 == 0
                   else (True, False, False, True)):
            walls[on].append(timed(on))
    names = (("default configuration", "kernel configuration")
             if args.kernel_config else ("plain skew path", "kernel pair"))
    for on, name in zip((False, True), names):
        med = float(np.median(walls[on]))
        print(f"B=8 T=1280 training step, {name}: walls "
              f"{', '.join(f'{x:.4f}' for x in walls[on])} s, median "
              f"{med:.4f} s, {frames / med:.0f} frames/s [{card}]",
              flush=True)

    configure(True)
    gens = step.gens
    parts = {"loss": [], "backward": [], "optimizer": []}
    for _ in range(args.rounds):
        t, noise, span = draw_inputs(gens, batch)
        opt.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model(**batch, noise=noise, t=t, speech_condition_mask=span,
                     gens=gens, train=True, dropout_rate=None,
                     batch_count=adjusted_batch_count(opt.step_count, 250.0))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[k].append(v)
    print(f"{names[1]} step split (median of rounds): " + ", ".join(
        f"{k} {float(np.median(v)):.4f} s" for k, v in parts.items())
        + f" [{card}]", flush=True)

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # device kernels only: the profiler also lays the optimizer's
    # ``Optimizer.step#...`` range over the device timeline
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)
              and not e.key.startswith("Optimizer.")]
    total_us = sum(e.self_device_time_total for e in events)
    calls = sum(e.count for e in events)

    def share(words):
        us = sum(e.self_device_time_total for e in events
                 if any(w in e.key for w in words))
        return f"{us / 1e3:.2f} ms ({100 * us / max(total_us, 1):.1f}%)"

    print(f"profiled {names[1]} step: wall {wall:.4f} s, device busy "
          f"{total_us / 1e6:.4f} s ({100 * total_us / 1e6 / wall:.1f}% of "
          f"this profiled wall), {calls} device kernels; attention pair "
          f"{share(ATTENTION_KERNELS)}, depthwise conv "
          f"{share(CONV_KERNELS)} [{card}]", flush=True)
    print("top device kernels (self device time):")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:20]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms "
              f"{e.count:6d} calls  {e.key[:100]}")
    return 0


# two duration buckets of 80 cuts each emit 10 batches of 8 (the last cut
# of each is dropped with its partial batch): about 19 steps, so that the
# CLI's profiler (batches 10-14) has untraced steps on both sides
CLI_UTTS = 160


def busy_seconds(trace_path):
    """Seconds in which the card ran a kernel, copy or set in a Chrome trace
    of torch.profiler (the union of those events' intervals)."""
    import json

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and "dur" in e)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e6


def train_cli(seed):
    """``--cli``: the trainer's steps at the base's widths, traced by the
    CLI's own profiler."""
    import tempfile

    import numpy as np

    from zipvoice_torch.bin import compute_fbank, prepare_dataset
    from zipvoice_torch.bin import train_zipvoice
    from zipvoice_torch.bin.make_model_dir import emilia_tokens
    from zipvoice_torch.frontend.audio import save_wav
    from zipvoice_torch.infer.workload import card_identity, speech_like_wav

    card = card_identity()
    with tempfile.TemporaryDirectory(prefix="zipvoice_probe_") as tmp:
        with open(os.path.join(REPO, "tools", "data",
                               "en_stream_corpus.txt"),
                  encoding="utf-8") as f:
            texts = [line.strip() for line in f if line.strip()]
        rows = []
        for i, sec in enumerate(np.linspace(12.4, 13.5, CLI_UTTS)):
            wav = os.path.join(tmp, f"utt{i:03d}.wav")
            save_wav(wav, speech_like_wav(seed + i, seconds=float(sec)),
                     24000)
            rows.append(f"utt{i:03d}\t{texts[i % len(texts)]}\t{wav}")
        tsv = os.path.join(tmp, "train.tsv")
        with open(tsv, "w", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")
        tokens = os.path.join(tmp, "tokens.txt")
        with open(tokens, "w", encoding="utf-8") as f:
            f.write("".join(f"{t}\t{i}\n"
                            for i, t in enumerate(emilia_tokens())))
        manifest = prepare_dataset.main([
            "--tsv-path", tsv, "--prefix", "probe", "--output-dir",
            os.path.join(tmp, "manifests")])
        compute_fbank.main(["--manifest", manifest, "--output-dir",
                            os.path.join(tmp, "fbank")])
        profile = os.path.join(tmp, "profile")
        history = train_zipvoice.main([
            "--train-manifest", manifest, "--token-file", tokens,
            "--tokenizer", "emilia", "--model-name", "zipvoice",
            "--exp-dir", os.path.join(tmp, "exp"), "--max-duration", "110",
            "--num-buckets", "2", "--num-epochs", "1", "--save-every-n",
            "0", "--log-interval", "100", "--seed", str(seed),
            "--profile-dir", profile])
        busy = busy_seconds(os.path.join(profile, "trace.json"))
    for h in history:
        B, S, T = h["shape"]
        print(f"train CLI step {h['step']} (B={B} S={S} T={T}): wall "
              f"{h['wall']:.4f} s, {h['frames'] / h['wall']:.0f} frames/s "
              f"[{card}]", flush=True)
    traced = history[10:15]
    # the untraced steps after the process's first
    steady = history[1:10] + history[15:]
    wall = float(np.median([h["wall"] for h in steady]))
    frames = float(np.median([h["frames"] / h["wall"] for h in steady]))
    print(f"train CLI, steps 2-10 and 16-{len(history)} (untraced): wall "
          f"median {wall:.4f} s, frames/s median {frames:.0f}; steps 11-15 "
          f"under its --profile-dir: device busy {busy / len(traced):.4f} s "
          f"a step ({100 * busy / len(traced) / wall:.1f}% of the untraced "
          f"median wall; the traced steps' own wall median "
          f"{float(np.median([h['wall'] for h in traced])):.4f} s) [{card}]",
          flush=True)
    if len(history) < 16 or not all(np.isfinite(h["loss"])
                                     for h in history):
        print(f"probe: {len(history)} steps, losses "
              f"{[h['loss'] for h in history]}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
