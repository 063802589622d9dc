#!/usr/bin/env python3
"""Run the PyTorch port of ZipVoice on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed 0] [--num-step 16]

Run from the root of a checkout, on a machine with an H100 (the CUDA kernels
are built for sm_90a).  Phases, each of which must pass:

1. build every CUDA kernel of the port from ``zipvoice_torch/csrc`` (one
   ``nvcc`` per source, all at once) and print the ptxas report and each
   kernel's tensor-core instructions in its SASS (``cuobjdump``);
2. hold the inference weights kernel against its plain PyTorch version
   on the card at B=16, h=4, T in {320, 640, 1280, 2560}, element by
   element, in bf16 (one rounding apart) and in f32 (2e-6), and time the
   bf16 build and the plain version (CUDA events; T=320 is below the gate,
   where the main path takes the plain version), and at T=1280 the fused
   weights + NonlinAttention kernel beside it;
3. drive the main path through ``InferencePipeline`` at full width (the
   ZipVoice base model, 16 steps with CFG, and the Vocos mel-24khz vocoder,
   bf16, random weights from ``--seed``) for three micro-batch requests,
   counting each kernel's launches;
4. rerun the largest request in f32 (TF32 off) with and without the kernel:
   the kernel path must agree with the plain path, and the bf16 run's
   distance from the f32 plain run is printed;
5. hold the training pair (the forward's training build and the backward
   kernel) against their plain versions at B=8, h=4, T in {640, 1280,
   2560} with padded keys, the score penalty off and on, in bf16 and f32:
   weights element by element as in phase 2, the largest |score| to 1e-6
   of itself, dq/dk/dp/dpe to 1e-4 of each tensor's largest |value|; and
   time both kernels and their plain versions at T=640 and 1280 (the
   training step's two levels);
6. take 6 ScaledAdam steps (Eden, clipping, schedules and scheduled
   dropout on) of the ZipVoice base at full width, f32 parameters and bf16
   compute, B=8, T=1280, S=128: finite losses and gradient norms, moved
   parameters, exactly 12 forward and 12 backward kernel launches per step;
   the median step time and frames/s are printed;
7. one f32 step (TF32 off) with the kernel pair and one without, from the
   same generators and batch: losses within 1e-5 of each other, every
   parameter's gradient within 1e-3 of its largest |value|, and 12 forward
   and 12 backward launches in the first run, none in the second;
8. hold the kernels of the kernel configuration against their plain
   versions on the card: the fused weights + NonlinAttention kernel and
   the application kernel at B=16, h=4, T in {640, 1279, 1280, 2560} with
   padded keys, the depthwise conv at B=16 and its backward at B=8 at the
   levels' shapes (C=512 with T 1280/640/320 and k 31/15/7, C=192 with
   T=128 and k=9), in bf16 (one rounding; na also the rounding of the
   weights it sums) and f32 (2e-6, for the f32 sums over T keys 2e-6 of
   max(1, the tensor's largest |value|); the backward's outputs within
   1e-4 of each tensor's largest |value|, plus one rounding in bf16), and
   time each beside its plain version and the PyTorch call that computes
   the same function (the fused kernel and the application kernel at T 640
   and 1280, the first beside the inference weights kernel, the second
   beside ``torch.matmul``; the conv pair at every level, beside
   ``F.conv1d`` and ``aten.convolution_backward``);
9. drive the B=8 request of phase 3 through ``InferencePipeline`` in the
   kernel configuration (every kernel switch on): launches as the model's
   switches and gates predict (no inference-weights launch), its wall
   printed beside the default configuration's; then the same request in
   f32 (TF32 off) in the kernel configuration, within PATH_ATOL of phase
   4's plain path;
10. take 2 full-width bf16 training steps in the kernel configuration (the
   conv pair beside the attention pair), with exactly one conv forward and
   one conv backward launch per ConvolutionModule a step, then one f32
   step with the conv pair and one without, from the same generators and
   batch, held as in phase 7;
11. the text -> wav path: write a model dir of the ZipVoice base at its
   published widths with random weights and a random Vocos
   (``bin/make_model_dir.py``) in a temporary directory, synthesize a 3 s
   prompt wav, load both in bf16 with ``load_model_dir`` and
   ``load_vocos``, and run ``generate_sentence`` (its micro-batch at the
   1280-frame bucket), ``generate_raw`` and ``generate_stream`` in process,
   each with #1's launches equal to what the model's gates predict for the
   buckets it dispatched and above 0, and its wavs checked (finite, within
   [-1, 1], one channel, between half and all of the generated frames'
   length; the stream's segments as long as the offline cross-fade of its
   chunks); then the CLI as a subprocess on a test list of an English line
   and a Chinese line with a <pinyin> tag: exit 0, two 24 kHz wavs, rtf
   logged.  Prints the write and load times, the front end's host time,
   ``t``, ``t_no_vocoder``, ``t_vocoder`` and the rtf;
12. the dialog models: write model dirs of ZipVoice-Dialog and
   ZipVoice-Dialog-Stereo at the published widths with random weights (the
   Emilia vocabulary with [S1] and [S2]), synthesize two 3 s prompt wavs of
   two speakers, load each model in bf16 and run a three-turn dialog text
   through ``DialogInferencePipeline.generate_dialog`` (the two prompts
   merged) and ``StereoDialogInferencePipeline.generate_dialog_stereo``
   (the two prompts on opposite channels), each in the 1280-frame bucket
   with #1's launches equal to what the gates predict and above 0, the mono
   wav checked as phase 11's and the stereo wav (2, n), finite, within
   [-1, 1], both channels non-silent; then the stereo request in f32 (TF32
   off) with #1 and on the plain path, its (T, 200) features within
   PATH_ATOL; then ``bin/infer_zipvoice_dialog`` in process for the mono
   model and as a subprocess on a six-field test list for the stereo one:
   exit 0, 24 kHz wavs of one and two channels, rtf logged.  Prints the
   load times, the front end's host time, ``t``, ``t_vocoder`` and the rtf;
13. the server: write a ZipVoice-Distill model dir at the published
   widths with a random Vocos, load both in bf16 behind ``TTSEngine``
   (max_batch 8, 4 steps, guidance 3.0) and ``make_handler`` on a thread,
   warm the buckets the traffic hits through the engine's own threads
   (``TTSEngine.warm``), register four speakers (prefixes of one 3 s
   prompt, as the client makes them), check every route (health, models,
   /tts cached and inline with its phases >= 0, /v1/audio/speech as wav and
   pcm: 24 kHz mono wavs, finite, within [-1, 1]; 404 for an unknown
   voice), the first /tts's vocode_ms within 2x the median of the same
   request sent four times more, then run ``serving/client.py`` as a
   subprocess (four
   speakers, 16 requests at concurrency 1 and 8, texts of 143-181 tokens in
   the 1024- and 1280-frame buckets): a micro-batch of several speakers'
   rows, #1's launches as the gates predict for the recorded buckets and
   above 0; prints audio-s/s and latency P50/P90 and whether the sampler
   and the finisher overlapped.  Then one request through the engine
   against ``_sample_batch`` on a fresh pipeline with the same seed (within
   PATH_ATOL), the int8 pipeline's resident weight bytes (below 0.6x
   bf16's), its weights held plus its allocator peak across one request
   against bf16's (both byte counts printed; below bf16's, since int8
   expands one stack at a time, and at most bf16's plus the int8 bytes)
   and its features against bf16's on the same noise (mean relative |d| <
   0.15, #1 launched), the sample's wall at that request's bucket in int8
   and in bf16 (printed, alternating, ten each), and the server's entry
   point as a subprocess answering /health and one /tts;
14. the trainer's entry points at the ZipVoice base's published widths
   (f32 parameters, bf16 compute, the Emilia vocabulary): 20 synthetic
   utterances of 12.4-13.5 s with the first 20 sentences of
   ``tools/data/en_stream_corpus.txt`` through ``bin/prepare_dataset`` and
   ``bin/compute_fbank`` (the native .fz codec, or the phase fails); one
   epoch of ``bin/train_zipvoice`` (--max-duration 110, 2 buckets: two
   steps at B=8, T=1280), then ``--start-epoch 2`` (resumed from epoch-1:
   the step count carries on and epoch 2's first batch is an uninterrupted
   run's); each step's loss finite, its wall and frames/s printed, and
   #4's and #5's launches equal to the gates' count from each batch's
   (S, T);
   ``bin/generate_averaged_model --epoch 2 --avg 2``, whose .pt
   ``load_model_dir`` loads for one ``generate_sentence`` at (1, 192,
   1280) with 192 launches of #1; then ``bin/train_zipvoice_distill``
   stage first (the averaged model as teacher) and stage second (the EMA
   teacher), two steps each, with #1 (teacher) and #4/#5 (student) at
   the gates' count;
15. the exported engines (``serving/aot.py``): ``bin/export_model`` as
   subprocesses, beside the rest of the phase, for the base (bf16, 16
   steps, guidance 1.0) at phase 11's bucket (1, 192, 1280) and for
   ZipVoice-Distill (4 steps, guidance 3.0) at the three B=1 buckets of
   phase 13's c=1 traffic; in process, the kernel configuration's engine at
   (8, 256, 1280) (#2, #3 and #6 at the gates' count uncaptured, no #1) and
   the default one at phase 3's B=8 bucket, whose request (16 steps and
   the vocoder) is timed replayed against eager, ten each, alternating;
   then ``bin/infer_exported`` in process on phase 11's prompt and text
   (its wav checked, its launches printed), the base engine's programs
   uncaptured (192 launches of #1) against its replay (bit for bit) and
   against eager sampling, the same export in f32 (TF32 off) within
   PATH_ATOL of eager sampling; then the server's entry point with
   ``--engine-dir --warmup`` under phase 13's client at concurrency 1
   (every request an engine hit, from ``/health``'s counts) and 8, its
   P50, audio-s/s and sample ms printed beside phase 13's eager server.
   Each engine's export, load and capture seconds, file bytes, graph pool
   bytes and graph nodes are printed;
16. multi-process training (``parallel/mesh.py``): (a) 20 synthetic
   utterances with Spanish texts through ``bin/prepare_dataset``,
   ``bin/compute_fbank``, ``bin/prepare_tokens --tokenizer espeak --lang
   es`` and ``bin/build_tokens`` (the texts' token counts printed for the
   eight first-party voices), then ``bin/train_zipvoice --tokenizer espeak
   --lang es`` as a subprocess on a one-process NCCL group
   (``--coordinator-address``, ``--num-processes 1``, ``--process-id 0``,
   ``--per-host-data on``) at the base's published widths: one epoch of two
   steps at (8, 96, 1280), finite losses, process 0's epoch-1 written, #4
   and #5 at the gates' count (12 + 12 a step), its step wall printed
   beside phase 14's without a group; (b) two processes on the one card
   over gloo (NCCL takes one process a device), f32 (TF32 off) at full
   width, B=8 split 4 + 4, two steps, against one process at B=8: losses
   within 1e-5 relative, every parameter within atol 1e-5, rtol 1e-4, both
   processes' parameters equal bit for bit; the largest |d| printed;
17. the gRPC pair, tensor parallelism and evaluation: (a) a
   ZipVoice-Distill model dir at the published widths behind
   ``TTSEngine`` (4 steps, guidance 3.0, max_batch 8) and the gRPC
   handler's three methods in process with a stub context: the phase-11
   prompt and its 2.28 s prefix registered, phase 13's texts 0 and 2
   synthesized in the 1280- and 1024-frame buckets (24 kHz mono WAVs,
   finite, within [-1, 1]), text 1 streamed (PCM longer than 0.1 s), #1's
   launches as the gates predict for the recorded buckets, an unknown
   speaker aborting with INVALID_ARGUMENT (3); where grpc imports, the
   same over the wire and ``serving/client_grpc.py`` as a subprocess (8
   requests at concurrency 1 and 4, P50/P90 and the stream's TTFB
   printed); (b) the base's fm_decoder, f32 (TF32 off), on two gloo
   processes on the one card, each with half of the heads and hidden units
   (``parallel/sharding_rules.shard_model``), one forward_fm_decoder at
   B=8, T=1280 within 2e-4 of one process's replicated forward, 12
   launches of #1 on each rank, each rank's parameter bytes printed beside
   the model's, and #1 held against its plain version in f32 (2e-6) at
   the head counts the ranks give it (2 and 3) at B=8, T in {1280, 640};
   (c) ``UTMOS22Strong`` (seeded random weights) on the card
   over (a)'s first WAV at 16 kHz within 1e-4 relative of the CPU, and the
   ECAPA head at WavLM-large widths (1024 features, 25 hidden states) over
   seeded (2, 1024, 200) features: a finite (2, 192) embedding.

Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, when
CUDA is unavailable or the port is not beside this script.
"""

import argparse
import gc
import json
import os
import re
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM rate and dense bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# kernel vs plain version, element by element.  Both sides take an f32
# softmax and round once to the output dtype, so in bf16 they may differ by
# one rounding: |d| <= 2^-7 |want| + 1e-6 (the 1e-6 covers weights that
# underflow on one side).  In f32 they agree to a few f32 roundings.
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-6
F32_ATOL = 2e-6
# kernel vs plain path through 16 f32 steps of the full model, in mel units:
# the CPU parity tests hold the port to JAX within 5e-3 on the model's
# features, which the pipeline scales by 1/0.1
PATH_ATOL = 5e-2


# card cycles of spin queued ahead of each timed call (about 150 us at the
# H100's clock): longer than the host takes to launch one call, a wrapper
# that allocates its outputs and launches three kernels included
SPIN_CYCLES_PER_CALL = 300_000


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events).  The timed
    calls are queued behind a spin of the card, so that the window holds
    them back to back: a kernel of a few microseconds is then timed, and
    not the host's pace of launching it."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved, flops):
    """(bound ms, what bounds it): the larger of the bytes over the HBM rate
    and the operations over the bf16 tensor rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# query rows per block of the bf16 weights kernels (rel_pos_sweeps.cuh,
# kRowsN): the training build writes one f32 |score| maximum per block
ROWS_PER_BLOCK = 64


def attention_traffic(B, h, T, qd, pd, train=False):
    """(bytes, operations) of the weights kernel in bf16: each input read
    once and the (B, h, T, T) output written once (and, for the training
    build, its per-block maxima), against the q.k + p.pe multiply-adds."""
    bytes_moved = (2 * (2 * B * h * T * qd + B * h * T * pd
                        + h * (2 * T - 1) * pd)
                   + B * T + 2 * B * h * T * T)
    if train:
        bytes_moved += 4 * B * h * -(-T // ROWS_PER_BLOCK)
    return bytes_moved, B * h * T * T * (2 * qd + 2 * pd)


def nonlin_traffic(B, h, T, qd, pd, hid):
    """(bytes, operations) of the fused weights + NonlinAttention kernel in
    bf16: the weights kernel's, plus nv read and na written once and head
    0's (T, T) @ (T, hid) products."""
    wb, wf = attention_traffic(B, h, T, qd, pd)
    return wb + 2 * 2 * B * T * hid, wf + 2 * B * T * T * hid


def apply_traffic(B, h, T, vd):
    """(bytes, operations) of the application kernel in bf16: the weights
    and values read once, the output written once; w @ v."""
    return 2 * (B * h * T * T + 2 * B * h * T * vd), 2 * B * h * T * T * vd


def conv_traffic(B, T, C, k, itemsize=2):
    """(bytes, operations) of the depthwise conv: v, w and b read once, the
    output written once; k multiply-adds and the bias per output."""
    return (itemsize * (2 * B * T * C + k * C + C),
            2 * B * T * C * k + B * T * C)


def conv_bwd_traffic(B, T, C, k, itemsize=2):
    """(bytes, operations) of the conv backward: v, g and w read once, dv,
    dw and db written once (all in the inputs' dtype); the dv and dw
    multiply-adds and the db sum."""
    return (itemsize * (3 * B * T * C + 2 * k * C + C),
            4 * B * T * C * k + B * T * C)


def attention_inputs(B, h, T, qd, pd, seed, dtype, device="cuda",
                     scale=1.0):
    """q, k, p, pe in ``dtype`` and a key mask with padded rows; row 3 is
    fully masked; q and k are scaled by ``scale``."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device=device)
                ).to(dtype)

    q, k = randn(B, h, T, qd, scale=scale), randn(B, h, T, qd, scale=scale)
    p, pe = randn(B, h, T, pd, scale=0.3), randn(h, 2 * T - 1, pd)
    lens = torch.randint(T // 2, T + 1, (B,), generator=g, device=device)
    lens[0], lens[3] = T, 0
    mask = torch.arange(T, device=device)[None, :] >= lens[:, None]
    return q, k, p, pe, mask


# training pair vs plain versions: the largest |score| is the max of the same
# f32 sums taken in another order (within 1e-6 of itself); the backward's f32
# outputs are sums of the same products in another order, held to 1e-4 of
# each tensor's largest |value|
SMAX_RTOL = 1e-6
BWD_RTOL = 1e-4
# f32 training step, kernel pair vs plain path (TF32 off): relative loss and
# per-tensor gradient bounds
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_RTOL = 1e-3
# full-width training: steps taken, and the pair's launches per step (the
# fm_decoder's 6 layers at T and 6 at T/2 pass the gate at T=1280)
TRAIN_STEPS = 6
TRAIN_LAUNCHES_PER_STEP = 12


# the kernel configuration's training run: the attention pair as in phase 6
# and, per ConvolutionModule, one conv forward and one conv backward a step
CONFIG_TRAIN_STEPS = 2


def kernel_wrappers():
    """Every kernel's wrapper, in the order of the kernel table."""
    from zipvoice_torch.kernels import depthwise_conv as dc
    from zipvoice_torch.kernels import rel_pos_attention as ra

    return (ra.rel_pos_attention_weights, ra.rel_pos_attention_weights_nonlin,
            ra.attention_apply, ra.rel_pos_attention_weights_train,
            ra.rel_pos_attention_weights_bwd, dc.depthwise_conv1d,
            dc.depthwise_conv1d_bwd)


def launch_counts():
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


def reset_launches():
    """Every kernel's launch count to 0, just before a path is driven."""
    for fn in kernel_wrappers():
        fn.launches = 0


def phase_kernels(card, seed):
    """Each kernel against its plain version at the main path's shapes: the
    bf16 build (the one the main path runs, also timed) and the f32 build."""
    from zipvoice_torch.kernels.rel_pos_attention import (
        rel_pos_attention_weights,
        rel_pos_attention_weights_nonlin,
        rel_pos_attention_weights_ref,
    )
    import torch

    # the plain version's f32 matmuls stay f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    B, h, qd, pd, hid = 16, 4, 32, 4, 384
    entry = None
    worst = 0.0
    # T=320: below MIN_SEQ_LEN (640, the TPU's gate), where the main path
    # takes the plain skew path; timed beside it for the gate's decision
    for T in (320, 640, 1280, 2560):
        args = attention_inputs(B, h, T, qd, pd, seed + T, torch.bfloat16)
        got = rel_pos_attention_weights(*args)
        torch.cuda.synchronize()
        want = rel_pos_attention_weights_ref(*args).float()
        diff = (got.float() - want).abs()
        err = diff.max().item()
        ratio = (diff / (BF16_RTOL * want.abs() + BF16_ATOL)).max().item()
        worst = max(worst, err)
        ms = cuda_ms(lambda: rel_pos_attention_weights(*args), iters=20)
        plain_ms = cuda_ms(lambda: rel_pos_attention_weights_ref(*args),
                           iters=5)
        bound_ms, bound_by = bound(*attention_traffic(B, h, T, qd, pd))
        print(f"kernel rel_pos_attention_weights B={B} h={h} T={T} bf16: "
              f"max|d| vs plain {err:.3e}, max |d|/(2^-7|want|+1e-6) "
              f"{ratio:.3f} (tol 1), kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"library_ms: none [{card}]", flush=True)
        if not ratio <= 1.0:
            raise AssertionError(f"bf16 kernel disagrees at T={T}: {ratio}")
        if T == 1280:  # the main path's top level
            entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by)
            # the fused weights + NonlinAttention kernel on the same inputs:
            # the same weights plus head 0's na, so #1 should be the faster
            nv = torch.randn(B, T, hid, device="cuda").to(torch.bfloat16)
            fused_ms = cuda_ms(lambda: rel_pos_attention_weights_nonlin(
                *args, nv), iters=20)
            print(f"timed B={B} h={h} T={T} bf16 [{card}]: "
                  f"rel_pos_attention_weights {ms:.4f} ms, "
                  f"rel_pos_attention_weights_nonlin (hid {hid}) beside it "
                  f"{fused_ms:.4f} ms ({fused_ms / ms:.2f}x #1's time)",
                  flush=True)
            del nv
        del args, got, want, diff
        args = attention_inputs(B, h, T, qd, pd, seed + T, torch.float32)
        got = rel_pos_attention_weights(*args)
        torch.cuda.synchronize()
        err32 = (got - rel_pos_attention_weights_ref(*args)).abs().max().item()
        print(f"kernel rel_pos_attention_weights B={B} h={h} T={T} f32: "
              f"max|d| vs plain {err32:.3e} (tol {F32_ATOL:.0e})", flush=True)
        if not err32 <= F32_ATOL:
            raise AssertionError(f"f32 kernel disagrees at T={T}: {err32}")
        del args, got
        torch.cuda.empty_cache()
    entry["max_abs_err"] = worst
    return {"rel_pos_attention_weights": entry}


def expected_launches(model, S, T, num_step):
    """Each kernel's launches for one sample, from the model's switches and
    gates: per fm_decoder call (num_step of them) and the text encoder's
    once, every layer whose level passes a kernel's gate launches it (the
    fused kernel in place of the weights kernel where it is on), and every
    ConvolutionModule with its kernel on launches the conv."""
    from collections import Counter

    from zipvoice_torch.models.zipformer import (
        MIN_APPLY_SEQ_LEN,
        MIN_SEQ_LEN,
        EncoderStack,
    )

    def count(zipformer, length):
        n = Counter()
        for stack in zipformer.encoders:
            ds = stack.downsample_factor if isinstance(stack, EncoderStack) \
                else 1
            enc = stack.encoder if isinstance(stack, EncoderStack) else stack
            level = (length + ds - 1) // ds
            for layer in enc.layers:
                fused = layer.fuse_nonlin and level >= MIN_SEQ_LEN
                n["rel_pos_attention_weights_nonlin"] += fused
                n["rel_pos_attention_weights"] += (
                    not fused and layer.self_attn_weights.use_kernel
                    and level >= MIN_SEQ_LEN)
                n["attention_apply"] += sum(
                    a.use_kernel and level >= MIN_APPLY_SEQ_LEN
                    for a in (layer.self_attn1, layer.self_attn2))
                n["depthwise_conv1d"] += sum(
                    c.use_kernel
                    for c in (layer.conv_module1, layer.conv_module2))
        return n

    want = {fn.__name__: 0 for fn in kernel_wrappers()}
    for name, n in count(model.fm_decoder, T).items():
        want[name] += n * num_step
    for name, n in count(model.text_encoder, S).items():
        want[name] += n
    return want


def phase_main_path(card, seed, num_step):
    import torch

    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.infer.workload import (
        build_base,
        micro_batches,
        run_request,
    )

    t0 = time.perf_counter()
    model, vocos = build_base(seed, torch.bfloat16)
    n_params = sum(p.numel() for p in model.fm_decoder.parameters())
    print(f"main path: ZipVoice base (fm_decoder {n_params / 1e6:.1f}M "
          f"params) + Vocos mel-24khz, bf16, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    pipe = InferencePipeline(model, vocos, seed=seed)
    reqs = micro_batches(model.feat_dim, seed)

    # first touch of each bucket (cuDNN plans, allocator) outside the
    # counted, timed run
    plans = []
    for req in reqs:
        seen = set(pipe._seen_buckets)
        run_request(pipe, req, num_step=1)
        (bucket,) = pipe._seen_buckets - seen
        plans.append(bucket)
    pipe.rng = np.random.RandomState(seed)

    reset_launches()
    outputs = []
    for req, (B, S, T) in zip(reqs, plans):
        noise_state = pipe.rng.get_state()
        before = launch_counts()
        feats, lens, wavs, wall = timed_request(pipe, req, num_step)
        launched = {n: c - before[n] for n, c in launch_counts().items()}
        want = expected_launches(model, S, T, num_step)
        audio_s = sum(len(w) for w in wavs) / pipe.sampling_rate
        print(f"request B={len(req['texts'])} (bucket B={B} S={S} T={T}): "
              f"{num_step} steps + vocoder in {wall:.3f} s wall for "
              f"{audio_s:.2f} s of audio, kernel launches "
              f"{launched['rel_pos_attention_weights']} (expected "
              f"{want['rel_pos_attention_weights']}) [{card}]", flush=True)
        if launched != want:
            raise AssertionError(f"launches {launched} != {want}")
        check_outputs(feats, lens, wavs)
        outputs.append((feats, lens, noise_state, wall, (B, S, T)))
    launches = launch_counts()["rel_pos_attention_weights"]
    return vocos, reqs[-1], outputs[-1], launches


def timed_request(pipe, req, num_step):
    """One request, synchronized: (feats, lens, wavs, wall seconds)."""
    import torch

    from zipvoice_torch.infer.workload import run_request

    torch.cuda.synchronize()
    t = time.perf_counter()
    feats, lens, wavs = run_request(pipe, req, num_step)
    torch.cuda.synchronize()
    return feats, lens, wavs, time.perf_counter() - t


def check_outputs(feats, lens, wavs):
    """Finite features and audio, 256 samples a frame."""
    for f, n, w in zip(feats, lens, wavs):
        if not (np.isfinite(f[:n]).all() and np.isfinite(w).all()):
            raise AssertionError("non-finite output")
        if w.shape != (n * 256,):
            raise AssertionError(f"wav {w.shape} for {n} frames")


def phase_f32_check(card, seed, num_step, vocos, req, bf16_out):
    """The B=8 request again in f32 with TF32 off: kernel path vs plain
    path (must agree), and the bf16 kernel run vs the f32 plain run."""
    import torch

    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.infer.workload import sample
    from zipvoice_torch.models.zipformer import set_attention_kernel
    from zipvoice_torch.models.zipvoice import build_zipvoice

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_zipvoice(vocab_size=360, dtype=torch.float32, seed=seed)
    runs = {}
    for use_kernel in (True, False):
        set_attention_kernel(model, use_kernel)
        pipe = InferencePipeline(model, vocos, seed=seed)
        pipe.rng.set_state(bf16_out[2])  # the bf16 run's noise
        runs[use_kernel] = sample(pipe, req, num_step)
    (fk, lk), (fp, lp) = runs[True], runs[False]
    if not (np.array_equal(lk, lp) and np.array_equal(lk, bf16_out[1])):
        raise AssertionError("lengths differ between runs")
    n = int(lk.max())
    # features are in mel units (the pipeline undoes its 0.1 feature scale)
    d_kernel = float(np.abs(fk[:, :n] - fp[:, :n]).max())
    d_bf16 = float(np.abs(bf16_out[0][:, :n] - fp[:, :n]).max())
    scale = float(np.abs(fp[:, :n]).mean())
    print(f"f32, TF32 off, B=8 T=1280: kernel path vs plain path mel "
          f"max|d| {d_kernel:.3e} (tol {PATH_ATOL:.0e}); bf16 kernel run vs "
          f"f32 plain run mel max|d| {d_bf16:.3e} (mean |mel| {scale:.3e}) "
          f"[{card}]", flush=True)
    if not d_kernel <= PATH_ATOL:
        raise AssertionError(f"kernel path disagrees: {d_kernel}")
    return runs[False]


def bwd_traffic(B, h, T, qd, pd, itemsize, penalty):
    """(bytes, operations) of the backward: g and w read once and q, k, p,
    pe once, dq, dk, dp, dpe written once in f32; its multiply-adds (row
    sums, ds, dq, dk, dp, dpe, and the score recompute when the penalty is
    live)."""
    bytes_moved = (2 * B * h * T * T * itemsize
                   + itemsize * (2 * B * h * T * qd + B * h * T * pd
                                 + h * (2 * T - 1) * pd)
                   + 4 * (2 * B * h * T * qd + B * h * T * pd
                          + h * (2 * T - 1) * pd))
    per_weight = 4 * qd + 4 * pd + 6 + (2 * qd + 2 * pd if penalty else 0)
    return bytes_moved, B * h * T * T * per_weight


def phase_train_kernels(card, seed):
    """The training pair against its plain versions at the training
    shapes, both dtypes, the penalty off and on; times at T=640 and 1280
    (the step's two levels; the entries keep T=1280, the top level)."""
    import torch

    from zipvoice_torch.kernels.rel_pos_attention import (
        SCORE_LIMIT,
        rel_pos_attention_weights_bwd,
        rel_pos_attention_weights_bwd_ref,
        rel_pos_attention_weights_train,
        rel_pos_attention_weights_train_ref,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    B, h, qd, pd = 8, 4, 32, 4
    entries = {}
    worst = {"fwd": 0.0, "bwd": 0.0}
    for T in (640, 1280, 2560):
        for dtype in (torch.bfloat16, torch.float32):
            for penalty in (False, True):
                args = attention_inputs(B, h, T, qd, pd, seed + T, dtype,
                                        scale=2.0 if penalty else 1.0)
                w, smax = rel_pos_attention_weights_train(*args)
                torch.cuda.synchronize()
                want, want_smax = rel_pos_attention_weights_train_ref(*args)
                diff = (w.float() - want.float()).abs()
                if dtype == torch.bfloat16:
                    ratio = (diff / (BF16_RTOL * want.float().abs()
                                     + BF16_ATOL)).max().item()
                else:
                    ratio = diff.max().item() / F32_ATOL
                d_smax = abs(smax.item() - want_smax.item())
                worst["fwd"] = max(worst["fwd"], diff.max().item())
                del want, diff
                live = want_smax.item() > SCORE_LIMIT
                coin = torch.tensor(float(penalty and live), device="cuda")
                g = torch.randn(w.shape, device="cuda",
                                generator=torch.Generator("cuda")
                                .manual_seed(seed + 1)).to(dtype)
                q, k, p, pe, _ = args
                got = rel_pos_attention_weights_bwd(q, k, p, pe, g, w, coin)
                torch.cuda.synchronize()
                ref = rel_pos_attention_weights_bwd_ref(q, k, p, pe, g, w,
                                                        coin)
                errs = [((a - b).abs().max().item(),
                         b.abs().max().item()) for a, b in zip(got, ref)]
                del got, ref
                worst["bwd"] = max([worst["bwd"]] + [e for e, _ in errs])
                tag = (f"B={B} h={h} T={T} {str(dtype)[6:]} penalty "
                       f"{'on' if penalty else 'off'} (max|score| "
                       f"{want_smax.item():.1f}, coin live {bool(coin)})")
                print(f"kernel rel_pos_attention_weights_train {tag}: max "
                      f"|d|/tol {ratio:.3f} (tol 1), |d smax| {d_smax:.3e} "
                      f"(tol {SMAX_RTOL:.0e}*{want_smax.item():.2f}); "
                      f"rel_pos_attention_weights_bwd max|d|/max|want| "
                      + ", ".join(f"{n} {e / max(m, 1e-30):.2e}" for n, (e, m)
                                  in zip(("dq", "dk", "dp", "dpe"), errs))
                      + f" (tol {BWD_RTOL:.0e})", flush=True)
                if not ratio <= 1.0:
                    raise AssertionError(f"train forward disagrees: {tag}")
                if not d_smax <= SMAX_RTOL * want_smax.item():
                    raise AssertionError(f"train smax disagrees: {tag}")
                if penalty and not live:
                    raise AssertionError(f"penalty inputs stay under the "
                                         f"limit: {tag}")
                for e, m in errs:
                    if not e <= BWD_RTOL * m:
                        raise AssertionError(f"backward disagrees: {tag}")
                if (T in (640, 1280) and dtype == torch.bfloat16
                        and not penalty):
                    ms = cuda_ms(lambda: rel_pos_attention_weights_train(
                        *args), iters=20)
                    plain_ms = cuda_ms(
                        lambda: rel_pos_attention_weights_train_ref(*args),
                        iters=5)
                    b_ms, b_by = bound(*attention_traffic(
                        B, h, T, qd, pd, train=True))
                    bms = cuda_ms(lambda: rel_pos_attention_weights_bwd(
                        q, k, p, pe, g, w, coin), iters=20)
                    bplain = cuda_ms(
                        lambda: rel_pos_attention_weights_bwd_ref(
                            q, k, p, pe, g, w, coin), iters=5)
                    bb_ms, bb_by = bound(*bwd_traffic(B, h, T, qd, pd, 2,
                                                      False))
                    if T == 1280:
                        entries["rel_pos_attention_weights_train"] = dict(
                            ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by)
                        entries["rel_pos_attention_weights_bwd"] = dict(
                            ms=bms, plain_ms=bplain, bound_ms=bb_ms,
                            bound_by=bb_by)
                    print(f"timed B={B} h={h} T={T} bf16 [{card}]: train "
                          f"forward {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                          f"bound {b_ms:.4f} ms, {b_by}); backward "
                          f"{bms:.4f} ms (plain {bplain:.4f} ms, bound "
                          f"{bb_ms:.4f} ms, {bb_by}); library_ms: none",
                          flush=True)
                del args, w, g, q, k, p, pe
                torch.cuda.empty_cache()
    entries["rel_pos_attention_weights_train"]["max_abs_err"] = worst["fwd"]
    entries["rel_pos_attention_weights_bwd"]["max_abs_err"] = worst["bwd"]
    return entries


def phase_train(card, seed):
    """TRAIN_STEPS ScaledAdam steps of the base model at full width, bf16
    compute over f32 parameters, every training schedule on."""
    import torch

    from zipvoice_torch.train.workload import build_trainer, train_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, opt, step = build_trainer(seed)
    batch = train_batch(seed)
    B, T, _ = batch["features"].shape
    frames = int(batch["features_lens"].sum())
    before = [p.detach().clone() for p in model.parameters()]
    torch.cuda.synchronize()
    reset_launches()
    walls, metrics = [], []
    for _ in range(TRAIN_STEPS):
        t = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = launch_counts()
    moved = max(float((p.detach() - b).abs().max())
                for p, b in zip(model.parameters(), before))
    med = float(np.median(walls[1:]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_params = sum(p.numel() for p in model.parameters())
    print(f"training: ZipVoice base ({n_params / 1e6:.1f}M f32 params, "
          f"bf16 compute), B={B} T={T} S=128, {TRAIN_STEPS} steps: "
          f"losses {[round(m['loss'], 4) for m in metrics]}, grad norms "
          f"{[round(m['grad_norm'], 3) for m in metrics]}, max |param "
          f"change| {moved:.3e}; launches {launches}; step wall "
          f"{[round(w, 4) for w in walls]} s, median after step 1 "
          f"{med:.4f} s, {frames / med:.0f} frames/s, peak memory "
          f"{peak:.1f} GiB [{card}]", flush=True)
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError("non-finite loss or gradient norm")
    if not moved > 0:
        raise AssertionError("parameters did not change")
    want = dict.fromkeys(launches, 0)
    want["rel_pos_attention_weights_train"] = TRAIN_LAUNCHES_PER_STEP * \
        TRAIN_STEPS
    want["rel_pos_attention_weights_bwd"] = TRAIN_LAUNCHES_PER_STEP * \
        TRAIN_STEPS
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    del model, opt, step, before
    torch.cuda.empty_cache()
    return launches, batch


def f32_train_run(model, seed, batch):
    """One f32 training loss and backward (TF32 off) from generators seeded
    with ``seed``: (loss, {name: gradient}, each kernel's launches)."""
    from zipvoice_torch.models.zipformer import TrainGenerators
    from zipvoice_torch.ops.schedule import adjusted_batch_count
    from zipvoice_torch.train.train_step import draw_inputs

    model.zero_grad(set_to_none=True)
    reset_launches()
    gens = TrainGenerators(seed, "cuda")
    t, noise, span = draw_inputs(gens, batch)
    loss = model(**batch, noise=noise, t=t, speech_condition_mask=span,
                 gens=gens, train=True, dropout_rate=None,
                 batch_count=adjusted_batch_count(0, 250.0))
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return loss.item(), grads, launch_counts()


def compare_train_runs(card, what, got, want, launches_got, launches_want):
    """Hold one f32 training run against another (loss within
    STEP_LOSS_RTOL, every gradient within STEP_GRAD_RTOL of its tensor's
    largest |value|) and each run's launches against what it must launch."""
    (lk, gk, ck), (lp, gp, cp) = got, want
    d_loss = abs(lk - lp) / abs(lp)
    worst, worst_name = 0.0, ""
    for n in gp:
        r = ((gk[n] - gp[n]).abs().max()
             / gp[n].abs().max().clamp(min=1e-30)).item()
        if r > worst:
            worst, worst_name = r, n
    nonzero = {c: {k: v for k, v in d.items() if v} for c, d in
               (("with", ck), ("without", cp))}
    print(f"f32 training step, TF32 off, B=8 T=1280, {what}: loss with "
          f"{lk:.6f} without {lp:.6f} (relative |d| {d_loss:.2e}, tol "
          f"{STEP_LOSS_RTOL:.0e}); worst gradient max|d|/max|g| "
          f"{worst:.2e} at {worst_name} (tol {STEP_GRAD_RTOL:.0e}); "
          f"launches {nonzero} [{card}]", flush=True)
    if ck != launches_got or cp != launches_want:
        raise AssertionError(f"launches {ck} and {cp}, want {launches_got} "
                             f"and {launches_want}")
    if not d_loss <= STEP_LOSS_RTOL:
        raise AssertionError(f"losses disagree: {lk} vs {lp}")
    if not worst <= STEP_GRAD_RTOL:
        raise AssertionError(f"gradients disagree at {worst_name}: {worst}")


def phase_train_f32_check(card, seed, batch):
    """One f32 training loss and backward (TF32 off) with the kernel pair
    and without it, from the same generators, coins and batch; the first
    must launch the pair at every gated layer, the second never.  Returns
    the model and the run with the pair, for phase 10."""
    import torch

    from zipvoice_torch.models.zipformer import set_attention_kernel
    from zipvoice_torch.models.zipvoice import build_zipvoice

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_zipvoice(vocab_size=360, dtype=torch.float32, seed=seed,
                           train=True)
    runs = {}
    for use_kernel in (True, False):
        set_attention_kernel(model, use_kernel)
        runs[use_kernel] = f32_train_run(model, seed, batch)
    none = dict.fromkeys(launch_counts(), 0)
    pair = dict(none, rel_pos_attention_weights_train=TRAIN_LAUNCHES_PER_STEP,
                rel_pos_attention_weights_bwd=TRAIN_LAUNCHES_PER_STEP)
    compare_train_runs(card, "attention pair vs plain path", runs[True],
                       runs[False], pair, none)
    set_attention_kernel(model, True)
    return model, runs[True]


# the conv levels of the main path: (C, T, k) of the fm_decoder's T, T/2 and
# T/4 stacks and of the text encoder
CONV_LEVELS = ((512, 1280, 31), (512, 640, 15), (512, 320, 7), (192, 128, 9))
# the conv backward vs its plain version: f32 sums over B x T products in
# another order, within 1e-4 of each tensor's largest |value|, plus in bf16
# the one rounding of the output dtype
CONV_BWD_RTOL = 1e-4


def close_ratio(got, want, dtype, sums=False, spread=None):
    """(max|d|, the largest |d| over its bound): bf16 one rounding,
    2^-7 |want| + 1e-6, plus 2^-7 ``spread`` where the output sums inputs
    that the two sides round each on their own (na sums weights that may
    differ by one rounding: spread = w[:, 0] @ |nv|); f32 F32_ATOL, for
    ``sums`` (f32 sums of T products: na and w @ v) F32_ATOL of max(1, the
    tensor's largest |value|).  Both sides sum in f32 in different orders;
    on an H100 the plain version's cuBLAS sum was the farther from an f64
    sum (3.7-6.5e-6 at |value| about 5, the kernel's 0.7-3.7e-6), past an
    absolute 2e-6."""
    import torch

    diff = (got.float() - want.float()).abs()
    if dtype == torch.bfloat16:
        bound = BF16_RTOL * want.float().abs() + BF16_ATOL
        if spread is not None:
            bound = bound + BF16_RTOL * spread
    elif sums:
        bound = F32_ATOL * max(1.0, want.abs().max().item())
    else:
        bound = F32_ATOL
    return diff.max().item(), (diff / bound).max().item()


def phase_config_kernels(card, seed):
    """The kernel configuration's kernels against their plain versions on
    the card, each dtype, the main path's shapes; times at the largest."""
    import torch
    import torch.nn.functional as F

    from zipvoice_torch.kernels.depthwise_conv import (
        depthwise_conv1d,
        depthwise_conv1d_bwd,
        depthwise_conv1d_bwd_ref,
        depthwise_conv1d_ref,
    )
    from zipvoice_torch.kernels.rel_pos_attention import (
        attention_apply,
        attention_apply_ref,
        rel_pos_attention_weights,
        rel_pos_attention_weights_nonlin,
        rel_pos_attention_weights_nonlin_ref,
    )

    # the plain versions' f32 matmuls and convolutions stay f32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, h, qd, pd, hid, vd = 16, 4, 32, 4, 384, 12
    entries = {}
    worst = dict.fromkeys(("rel_pos_attention_weights_nonlin",
                           "attention_apply", "depthwise_conv1d",
                           "depthwise_conv1d_bwd"), 0.0)

    def record(name, err, ratio, what):
        worst[name] = max(worst[name], err)
        if not ratio <= 1.0:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"({what}): {ratio}")

    # T=1279: a ragged length (no multiple of a row tile, key chunk or 8)
    for T in (640, 1279, 1280, 2560):
        for dtype in (torch.bfloat16, torch.float32):
            args = attention_inputs(B, h, T, qd, pd, seed + T, dtype)
            g = torch.Generator(device="cuda").manual_seed(seed + T + 1)
            nv = torch.randn(B, T, hid, generator=g, device="cuda").to(dtype)
            v = torch.randn(B, h, T, vd, generator=g, device="cuda").to(dtype)
            w, na = rel_pos_attention_weights_nonlin(*args, nv)
            torch.cuda.synchronize()
            want_w, want_na = rel_pos_attention_weights_nonlin_ref(*args, nv)
            ew, rw = close_ratio(w, want_w, dtype)
            spread = torch.matmul(want_w[:, 0].float(), nv.float().abs())
            en, rn = close_ratio(na, want_na, dtype, sums=True, spread=spread)
            del want_w, want_na, spread
            out = attention_apply(w, v)
            torch.cuda.synchronize()
            ea, ra = close_ratio(out, attention_apply_ref(w, v), dtype,
                                 sums=True)
            tag = f"B={B} h={h} T={T} {str(dtype)[6:]}"
            print(f"kernel rel_pos_attention_weights_nonlin {tag} hid={hid}: "
                  f"weights max|d| {ew:.3e} (|d|/tol {rw:.3f}), na max|d| "
                  f"{en:.3e} (|d|/tol {rn:.3f}); kernel attention_apply vd="
                  f"{vd}: max|d| {ea:.3e} (|d|/tol {ra:.3f}) (tol 1: bf16 "
                  f"2^-7|want|+1e-6, for na + 2^-7 w0 @ |nv|; f32 "
                  f"{F32_ATOL:.0e}, for na and w @ v of max(1, max|want|))",
                  flush=True)
            record("rel_pos_attention_weights_nonlin", max(ew, en),
                   max(rw, rn), tag)
            record("attention_apply", ea, ra, tag)
            if T in (640, 1280) and dtype == torch.bfloat16:
                ms = cuda_ms(lambda: rel_pos_attention_weights_nonlin(
                    *args, nv), iters=20)
                plain_ms = cuda_ms(
                    lambda: rel_pos_attention_weights_nonlin_ref(*args, nv),
                    iters=5)
                # the inference weights kernel on the same inputs: the
                # fusion pays where the fused kernel is the faster
                w_ms = cuda_ms(lambda: rel_pos_attention_weights(*args),
                               iters=20)
                b_ms, b_by = bound(*nonlin_traffic(B, h, T, qd, pd, hid))
                a_ms = cuda_ms(lambda: attention_apply(w, v), iters=20)
                a_plain = cuda_ms(lambda: attention_apply_ref(w, v), iters=5)
                # the one PyTorch call: a batched bf16 matmul (cuBLAS) on
                # the same contiguous (B, h, T, T) and (B, h, T, 12) tensors
                a_lib = cuda_ms(lambda: torch.matmul(w, v), iters=20)
                ab_ms, ab_by = bound(*apply_traffic(B, h, T, vd))
                if T == 1280:  # the main path's top level
                    entries["rel_pos_attention_weights_nonlin"] = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
                    entries["attention_apply"] = dict(
                        ms=a_ms, plain_ms=a_plain, bound_ms=ab_ms,
                        bound_by=ab_by, library_ms=a_lib)
                print(f"timed {tag} [{card}]: nonlin {ms:.4f} ms (plain "
                      f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms, {b_by}, "
                      f"library_ms: none; the weights kernel alone "
                      f"{w_ms:.4f} ms: fused {w_ms / ms:.2f}x as fast); "
                      f"apply {a_ms:.4f} ms (plain {a_plain:.4f} ms, bound "
                      f"{ab_ms:.4f} ms, {ab_by}, torch.matmul {a_lib:.4f} "
                      f"ms: {a_lib / a_ms:.2f}x as fast)", flush=True)
            del args, nv, v, w, na, out
            torch.cuda.empty_cache()

    for C, T, k in CONV_LEVELS:
        for dtype in (torch.bfloat16, torch.float32):
            # the model's own scales: unit activations, filter and bias
            # drawn as nn.Conv1d draws them, U(-1/sqrt(k), 1/sqrt(k))
            g = torch.Generator(device="cuda").manual_seed(seed + C + T + k)
            lim = k ** -0.5

            def uniform(*shape):
                return ((2 * torch.rand(*shape, generator=g, device="cuda")
                         - 1) * lim).to(dtype)

            w, b = uniform(C, k), uniform(C)
            v = torch.randn(B, T, C, generator=g, device="cuda").to(dtype)
            got = depthwise_conv1d(v, w, b)
            torch.cuda.synchronize()
            ef, rf = close_ratio(got, depthwise_conv1d_ref(v, w, b), dtype)
            tag = f"C={C} T={T} k={k} {str(dtype)[6:]}"
            record("depthwise_conv1d", ef, rf, f"B={B} {tag}")
            Bt = 8
            vt = v[:Bt].contiguous()
            gt = torch.randn(Bt, T, C, generator=g, device="cuda").to(dtype)
            got_b = depthwise_conv1d_bwd(vt, gt, w)
            torch.cuda.synchronize()
            want_b = depthwise_conv1d_bwd_ref(vt, gt, w)
            ratios = []
            for a, r in zip(got_b, want_b):
                tol = CONV_BWD_RTOL * r.float().abs().max().item()
                if dtype == torch.bfloat16:
                    tol = tol + BF16_RTOL * r.float().abs()
                d = (a.float() - r.float()).abs()
                ratios.append((d / tol).max().item())
                worst["depthwise_conv1d_bwd"] = max(
                    worst["depthwise_conv1d_bwd"], d.max().item())
            print(f"kernel depthwise_conv1d B={B} {tag}: max|d| {ef:.3e} "
                  f"(|d|/tol {rf:.3f}); depthwise_conv1d_bwd B={Bt}: |d|/tol "
                  f"dv {ratios[0]:.3f}, dw {ratios[1]:.3f}, db "
                  f"{ratios[2]:.3f} (tol 1: {CONV_BWD_RTOL:.0e} max|want| "
                  f"+ in bf16 2^-7|want|)", flush=True)
            if not max(ratios) <= 1.0:
                raise AssertionError(f"conv backward disagrees: {tag} "
                                     f"{ratios}")
            if dtype == torch.bfloat16:
                ms = cuda_ms(lambda: depthwise_conv1d(v, w, b), iters=20)
                plain_ms = cuda_ms(lambda: depthwise_conv1d_ref(v, w, b),
                                   iters=5)
                # the one PyTorch call: F.conv1d in bf16 on the
                # (B, C, T) layout it takes, made contiguous before the
                # timed window (the port's default path also pays two
                # transposes around it)
                v_ct = v.transpose(1, 2).contiguous()
                w3 = w[:, None, :].contiguous()
                lib = cuda_ms(lambda: F.conv1d(v_ct, w3, b, padding=k // 2,
                                               groups=C), iters=20)
                b_ms, b_by = bound(*conv_traffic(B, T, C, k))
                bms = cuda_ms(lambda: depthwise_conv1d_bwd(vt, gt, w),
                              iters=20)
                bplain = cuda_ms(lambda: depthwise_conv1d_bwd_ref(vt, gt, w),
                                 iters=5)
                # aten.convolution_backward in bf16 for dv, dw and
                # db on contiguous (B, C, T) tensors
                vt_ct = vt.transpose(1, 2).contiguous()
                gt_ct = gt.transpose(1, 2).contiguous()
                blib = cuda_ms(lambda: torch.ops.aten.convolution_backward(
                    gt_ct, vt_ct, w3, [C], [1], [k // 2], [1], False, [0], C,
                    [True, True, True]), iters=20)
                bb_ms, bb_by = bound(*conv_bwd_traffic(Bt, T, C, k))
                if (C, T, k) == CONV_LEVELS[0]:  # the main path's top level
                    entries["depthwise_conv1d"] = dict(
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=lib)
                    entries["depthwise_conv1d_bwd"] = dict(
                        ms=bms, plain_ms=bplain, bound_ms=bb_ms,
                        bound_by=bb_by, library_ms=blib)
                print(f"timed conv C={C} T={T} k={k} bf16 [{card}]: forward "
                      f"B={B} {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
                      f"{b_ms:.4f} ms, {b_by}, F.conv1d {lib:.4f} ms: "
                      f"{lib / ms:.2f}x as fast); backward B={Bt} "
                      f"{bms:.4f} ms (plain {bplain:.4f} ms, bound "
                      f"{bb_ms:.4f} ms, {bb_by}, aten.convolution_backward "
                      f"{blib:.4f} ms: {blib / bms:.2f}x as fast)",
                      flush=True)
            del v, w, b, vt, gt, got, got_b, want_b
            torch.cuda.empty_cache()
    for name, err in worst.items():
        entries[name]["max_abs_err"] = err
    return entries


def phase_config_request(card, seed, num_step, vocos, req, bf16_out,
                         f32_plain):
    """Phase 3's B=8 request in the kernel configuration: launches as the
    model predicts, its wall beside the default configuration's; then in
    f32 against phase 4's plain path."""
    import torch

    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.infer.workload import run_request, sample
    from zipvoice_torch.models.zipvoice import build_zipvoice

    feats0, lens0, noise_state, default_wall, (_, S, T) = bf16_out
    model = build_zipvoice(vocab_size=360, dtype=torch.bfloat16, seed=seed,
                           kernel_config=True)
    pipe = InferencePipeline(model, vocos, seed=seed)
    run_request(pipe, req, num_step=1)  # first touch, not counted
    pipe.rng.set_state(noise_state)
    reset_launches()
    feats, lens, wavs, wall = timed_request(pipe, req, num_step)
    launched = launch_counts()
    want = expected_launches(model, S, T, num_step)
    check_outputs(feats, lens, wavs)
    if not np.array_equal(lens, lens0):
        raise AssertionError("lengths differ from the default configuration")
    n = int(lens.max())
    d_default = float(np.abs(feats[:, :n] - feats0[:, :n]).max())
    print(f"kernel configuration, B=8 request (S={S} T={T}), {num_step} "
          f"steps + vocoder, bf16: {wall:.3f} s wall (default configuration "
          f"{default_wall:.3f} s); launches "
          f"{ {k: v for k, v in launched.items() if v} } (expected "
          f"{ {k: v for k, v in want.items() if v} }); mel max|d| vs the "
          f"default configuration {d_default:.3e} [{card}]", flush=True)
    if launched != want or want["rel_pos_attention_weights"] != 0:
        raise AssertionError(f"launches {launched}, want {want} (and no "
                             f"inference-weights launch)")
    del model, pipe
    torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_zipvoice(vocab_size=360, dtype=torch.float32, seed=seed,
                           kernel_config=True)
    pipe = InferencePipeline(model, vocos, seed=seed)
    pipe.rng.set_state(noise_state)
    fk, lk = sample(pipe, req, num_step)
    fp, lp = f32_plain
    if not np.array_equal(lk, lp):
        raise AssertionError("lengths differ between runs")
    n = int(lk.max())
    d = float(np.abs(fk[:, :n] - fp[:, :n]).max())
    print(f"f32, TF32 off, B=8 T=1280: kernel configuration vs plain path "
          f"mel max|d| {d:.3e} (tol {PATH_ATOL:.0e}) [{card}]", flush=True)
    if not d <= PATH_ATOL:
        raise AssertionError(f"kernel configuration disagrees: {d}")
    return launched


def phase_config_train(card, seed, batch, f32_model, f32_pair_run):
    """CONFIG_TRAIN_STEPS full-width bf16 steps in the kernel
    configuration, then phase 7's f32 run again with the conv pair on."""
    import torch

    from zipvoice_torch.models.zipformer import (
        ConvolutionModule,
        set_conv_kernel,
    )
    from zipvoice_torch.train.workload import build_trainer

    model, opt, step = build_trainer(seed, kernel_config=True)
    n_conv = sum(m.use_kernel for m in model.modules()
                 if isinstance(m, ConvolutionModule))
    torch.cuda.synchronize()
    reset_launches()
    walls, metrics = [], []
    for _ in range(CONFIG_TRAIN_STEPS):
        t = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
    launches = launch_counts()
    per_step = dict.fromkeys(launches, 0)
    per_step.update(
        rel_pos_attention_weights_train=TRAIN_LAUNCHES_PER_STEP,
        rel_pos_attention_weights_bwd=TRAIN_LAUNCHES_PER_STEP,
        depthwise_conv1d=n_conv, depthwise_conv1d_bwd=n_conv)
    want = {k: v * CONFIG_TRAIN_STEPS for k, v in per_step.items()}
    print(f"training, kernel configuration, B=8 T=1280 S=128, "
          f"{CONFIG_TRAIN_STEPS} bf16 steps: losses "
          f"{[round(m['loss'], 4) for m in metrics]}, grad norms "
          f"{[round(m['grad_norm'], 3) for m in metrics]}; launches "
          f"{ {k: v for k, v in launches.items() if v} } ({n_conv} "
          f"ConvolutionModules); step wall {[round(w, 4) for w in walls]} s "
          f"[{card}]", flush=True)
    if not all(np.isfinite(v) for m in metrics for v in m.values()):
        raise AssertionError("non-finite loss or gradient norm")
    if launches != want:
        raise AssertionError(f"launches {launches}, want {want}")
    del model, opt, step
    torch.cuda.empty_cache()

    set_conv_kernel(f32_model, True)
    run = f32_train_run(f32_model, seed, batch)
    pair = dict(per_step, depthwise_conv1d=0, depthwise_conv1d_bwd=0)
    compare_train_runs(card, "conv pair vs F.conv1d (attention pair on "
                       "in both)", run, f32_pair_run, per_step, pair)
    return launches


# phase 11: a 3 s prompt of about 45 phone tokens ("The birch canoe ...",
# 2.8 s once trimmed) and a two-sentence text of 144 tokens: one chunk, which
# lands in the 1280-frame bucket, where #1 runs at the top two levels
CLI_PROMPT_TEXT = "The birch canoe slid on the smooth planks."
CLI_TEXT = ("Across the valley, the old mill still turns when the spring "
            "rains come. Travelers who stop by are offered warm bread and a "
            "seat by the fire.")
CLI_ZH_TEXT = "今天天气很好，我们去<hai3>边散步吧。"
# generate_sentence runs timed again after the counted one, for the spread
CLI_REPEATS = 3


def record_dispatches(model):
    """Wrap ``model.sample`` so that each call appends its (B, S, T) to the
    returned list; ``del model.sample`` undoes it."""
    dispatched = []
    inner = model.sample

    def sample(**kw):
        dispatched.append((kw["tokens"].shape[0], kw["tokens"].shape[1],
                           kw["prompt_features"].shape[1]))
        return inner(**kw)

    model.sample = sample
    return dispatched


def counted(card, what, model, num_step, fn):
    """Run ``fn`` with every launch count at 0 just before it and the
    model's dispatches recorded: the launches must equal what
    ``expected_launches`` predicts for those buckets, and #1's must be
    more than 0.  Returns (fn's result, #1's launches, seconds)."""
    import torch

    dispatched = record_dispatches(model)
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launched = launch_counts()
    del model.sample
    want = dict.fromkeys(launched, 0)
    for _, S, T in dispatched:
        for name, n in expected_launches(model, S, T, num_step).items():
            want[name] += n
    print(f"{what}: buckets (B, S, T) {dispatched}, launches "
          f"{ {k: v for k, v in launched.items() if v} } (expected "
          f"{ {k: v for k, v in want.items() if v} }) [{card}]", flush=True)
    if launched != want or launched["rel_pos_attention_weights"] <= 0:
        raise AssertionError(f"{what}: launches {launched}, want {want}")
    return out, launched["rel_pos_attention_weights"], seconds


def check_wav(what, wav, frames):
    """One finite channel within [-1, 1], between half and all of the
    ``frames`` x 256 / 24000 s that the model generated."""
    most = frames * 256 / 24000
    seconds = wav.shape[-1] / 24000
    if wav.ndim != 2 or wav.shape[0] != 1:
        raise AssertionError(f"{what}: wav of shape {wav.shape}")
    if not (np.isfinite(wav).all() and np.abs(wav).max() <= 1.0):
        raise AssertionError(f"{what}: wav not finite or outside [-1, 1]")
    if not most / 2 <= seconds <= most:
        raise AssertionError(f"{what}: {seconds:.3f} s of wav for {frames} "
                             f"frames ({most:.3f} s)")


def phase_cli(card, seed):
    """The text -> wav path at full width: a model dir of the ZipVoice base
    (published widths, random weights from ``seed``) and a random Vocos
    from ``bin/make_model_dir.py``, loaded in bf16 through
    ``load_model_dir`` and ``load_vocos``; ``generate_sentence``,
    ``generate_raw`` and ``generate_stream`` in process with #1's launches
    counted; then the CLI as a subprocess on a test list of an English and
    a Chinese line.  Returns #1's launches in ``generate_sentence``."""
    import shutil
    import subprocess
    import tempfile
    import wave

    import torch

    from zipvoice_torch.bin.make_model_dir import BASE_CONFIG, make_model_dir
    from zipvoice_torch.frontend.audio import cross_fade_concat, save_wav
    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.infer.workload import speech_like_wav
    from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos

    tmp = tempfile.mkdtemp(prefix="zipvoice_cli_")
    try:
        t = time.perf_counter()
        make_model_dir(tmp, config=BASE_CONFIG, seed=seed, vocos_config={})
        write_s = time.perf_counter() - t
        model_mb = os.path.getsize(os.path.join(tmp, "model.pt")) / 2 ** 20
        prompt = os.path.join(tmp, "prompt.wav")
        save_wav(prompt, speech_like_wav(seed, seconds=3.0), 24000)

        torch.cuda.synchronize()
        t = time.perf_counter()
        model, tokenizer = load_model_dir(tmp, dtype=torch.bfloat16)
        vocos = load_vocos(os.path.join(tmp, "pytorch_model.bin"),
                           dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        n_params = sum(p.numel() for p in model.parameters())
        print(f"CLI path: model dir written in {write_s:.2f} s (model.pt "
              f"{model_mb:.1f} MiB, {n_params / 1e6:.1f}M params), "
              f"load_model_dir + load_vocos in bf16 to the card in "
              f"{load_s:.2f} s [{card}]", flush=True)
        pipe = InferencePipeline(model, vocos, seed=seed, tokenizer=tokenizer)
        num_step = 16
        kw = dict(num_step=num_step, guidance_scale=1.0)
        text_tokens = tokenizer.texts_to_tokens([CLI_TEXT])[0]
        prompt_tokens = tokenizer.texts_to_tokens([CLI_PROMPT_TEXT])[0]
        print(f"CLI path: prompt 3.00 s, {len(prompt_tokens)} prompt tokens, "
              f"{len(text_tokens)} text tokens ({len(CLI_TEXT.split())} "
              f"words)", flush=True)

        def sentence():
            return pipe.generate_sentence(CLI_PROMPT_TEXT, prompt, CLI_TEXT,
                                          **kw)

        sentence()  # first touch of the bucket, not counted
        (wav, m), launches, _ = counted(card, "generate_sentence", model,
                                        num_step, sentence)
        check_wav("generate_sentence", wav, m["frames"])
        print(f"generate_sentence: chunks of {m['chunk_tokens']} tokens, "
              f"{m['frames']} frames, {m['wav_seconds']:.3f} s of wav; front "
              f"end (prompt trim, fbank, tokens) {m['t_frontend']:.4f} s on "
              f"the host; t {m['t']:.4f} s (t_no_vocoder "
              f"{m['t_no_vocoder']:.4f}, t_vocoder {m['t_vocoder']:.4f}), "
              f"rtf {m['rtf']:.4f}, bf16, {num_step} steps [{card}]",
              flush=True)
        if not any(T == 1280 for _, _, T in pipe._seen_buckets):
            raise AssertionError(f"no micro-batch at the 1280-frame bucket: "
                                 f"{pipe._seen_buckets}")
        again = [sentence()[1] for _ in range(CLI_REPEATS)]
        print(f"generate_sentence again, {CLI_REPEATS} runs: t "
              f"{[round(r['t'], 4) for r in again]} s, t_frontend "
              f"{[round(r['t_frontend'], 4) for r in again]} s [{card}]",
              flush=True)

        frames = []
        inner = pipe._sample_batch

        def keep_frames(*args, **kwargs):
            feats, lens = inner(*args, **kwargs)
            frames.extend(int(n) for n in lens)
            return feats, lens

        pipe._sample_batch = keep_frames
        (raw, rm), _, _ = counted(
            card, "generate_raw", model, num_step,
            lambda: pipe.generate_raw(CLI_PROMPT_TEXT, prompt, CLI_TEXT,
                                      **kw))
        check_wav("generate_raw", raw, frames[-1])
        print(f"generate_raw: {rm['wav_seconds']:.3f} s of wav, t "
              f"{rm['t']:.4f} s, rtf {rm['rtf']:.4f} [{card}]", flush=True)

        chunk_wavs = []
        vocode = pipe._vocode_chunks

        def keep_wavs(feats):
            out = vocode(feats)
            chunk_wavs.extend(out)
            return out

        pipe._vocode_chunks = keep_wavs
        p_tok = tokenizer.texts_to_token_ids([CLI_PROMPT_TEXT])[0]
        p_feat = pipe.feature_extractor.extract(
            speech_like_wav(seed, seconds=3.0), 24000) * pipe.feat_scale
        segs, _, stream_s = counted(
            card, "generate_stream", model, num_step,
            lambda: list(pipe.generate_stream(p_tok, p_feat, CLI_TEXT,
                                              **kw)))
        offline = cross_fade_concat([w[None] for w in chunk_wavs], 0.1,
                                    24000)
        got = sum(s.shape[-1] for s in segs)
        print(f"generate_stream: {len(chunk_wavs)} chunk(s), {len(segs)} "
              f"segments, {got} samples (offline cross-fade "
              f"{offline.shape[-1]}), {stream_s:.4f} s [{card}]", flush=True)
        if not all(np.isfinite(s).all() for s in segs):
            raise AssertionError("generate_stream: non-finite segment")
        if got != offline.shape[-1]:
            raise AssertionError(f"generate_stream: {got} samples, offline "
                                 f"{offline.shape[-1]}")
        del model, vocos, pipe
        torch.cuda.empty_cache()

        res = os.path.join(tmp, "res")
        test_list = os.path.join(tmp, "test.tsv")
        with open(test_list, "w", encoding="utf-8") as f:
            f.write(f"en\t{CLI_PROMPT_TEXT}\t{prompt}\t{CLI_TEXT}\n")
            f.write(f"zh\t{CLI_PROMPT_TEXT}\t{prompt}\t{CLI_ZH_TEXT}\n")
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "zipvoice_torch.bin.infer_zipvoice",
             "--model-dir", tmp, "--vocoder-path",
             os.path.join(tmp, "pytorch_model.bin"), "--bf16",
             "--test-list", test_list, "--res-dir", res],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=600,
        )
        cli_s = time.perf_counter() - t
        log = [line for line in r.stderr.splitlines() if "rtf" in line]
        print(f"CLI subprocess: exit {r.returncode} in {cli_s:.1f} s; "
              + " | ".join(line.split(":", 2)[-1].strip() for line in log)
              + f" [{card}]", flush=True)
        if r.returncode != 0:
            raise AssertionError(f"CLI failed:\n{r.stderr[-4000:]}")
        if len(log) < 3:
            raise AssertionError(f"CLI logged no rtf:\n{r.stderr[-4000:]}")
        for name in ("en", "zh"):
            with wave.open(os.path.join(res, name + ".wav"), "rb") as f:
                if (f.getframerate(), f.getnchannels()) != (24000, 1) \
                        or f.getnframes() == 0:
                    raise AssertionError(f"CLI wav {name}: "
                                         f"{f.getframerate()} Hz, "
                                         f"{f.getnchannels()} channel(s), "
                                         f"{f.getnframes()} frames")
    finally:
        shutil.rmtree(tmp)
    return launches


# phase 12: two speakers' 3 s prompts (about 2.8 s each once trimmed, 93
# prompt tokens with the turns) and a three-turn text of 105 tokens: one
# chunk, which lands in the 1280-frame bucket in both models (mono: the 5.6 s
# merged prompt and about 580 frames; stereo: the 6 s two-channel prompt and
# about 640), where #1 runs at the top two levels
DIALOG_PROMPT_TEXTS = ["The birch canoe slid on the smooth planks.",
                       "Glue the sheet to the dark blue background."]
DIALOG_TEXT = ("[S1] Did you see the river this morning? [S2] I did, the "
               "water was high after the rain. [S1] Then we should wait a "
               "day.")


def check_stereo_wav(what, wav, frames):
    """Two finite channels within [-1, 1], neither silent, as long as the
    ``frames`` the model generated."""
    if wav.ndim != 2 or wav.shape != (2, frames * 256):
        raise AssertionError(f"{what}: wav of shape {wav.shape} for {frames} "
                             f"frames")
    if not (np.isfinite(wav).all() and np.abs(wav).max() <= 1.0):
        raise AssertionError(f"{what}: wav not finite or outside [-1, 1]")
    rms = np.sqrt(np.mean(np.square(wav), axis=1))
    if not (rms > 1e-4).all():
        raise AssertionError(f"{what}: a silent channel (rms {rms})")


def run_dialog_cli(argv):
    """``bin/infer_zipvoice_dialog.main(argv)`` in this process, its log
    records kept: (exit code, the log's lines)."""
    import logging

    from zipvoice_torch.bin.infer_zipvoice_dialog import main as cli_main

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    keep, root = Keep(), logging.getLogger()
    level = root.level
    root.addHandler(keep)
    root.setLevel(logging.INFO)
    try:
        rc = cli_main(argv)
    finally:
        root.removeHandler(keep)
        root.setLevel(level)
    return rc, keep.lines


def read_wav_header(path):
    import wave

    with wave.open(path, "rb") as f:
        return f.getframerate(), f.getnchannels(), f.getnframes()


def phase_dialog(card, seed):
    """ZipVoice-Dialog and ZipVoice-Dialog-Stereo at full width: model dirs
    from ``bin/make_model_dir.py``, loaded in bf16 through
    ``load_model_dir``; ``generate_dialog`` and ``generate_dialog_stereo``
    with #1's launches counted; the stereo request in f32 with #1 and on
    the plain path; then the dialog CLI in process (mono) and as a
    subprocess (stereo).  Returns #1's launches in the two requests."""
    import shutil
    import subprocess
    import tempfile

    import torch

    from zipvoice_torch.bin.make_model_dir import BASE_CONFIG, make_model_dir
    from zipvoice_torch.frontend.audio import save_wav
    from zipvoice_torch.infer.dialog_pipeline import (
        DialogInferencePipeline,
        StereoDialogInferencePipeline,
    )
    from zipvoice_torch.infer.workload import speech_like_wav
    from zipvoice_torch.models.zipformer import set_attention_kernel
    from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos

    tmp = tempfile.mkdtemp(prefix="zipvoice_dialog_")
    num_step = 16
    kw = dict(num_step=num_step, guidance_scale=1.5)
    launches = {}
    try:
        mono_dir = os.path.join(tmp, "zipvoice_dialog")
        stereo_dir = os.path.join(tmp, "zipvoice_dialog_stereo")
        vocos_path = os.path.join(mono_dir, "pytorch_model.bin")
        t = time.perf_counter()
        make_model_dir(mono_dir, "zipvoice_dialog", config=BASE_CONFIG,
                       seed=seed, vocos_config={})
        make_model_dir(stereo_dir, "zipvoice_dialog_stereo",
                       config=BASE_CONFIG, seed=seed + 1)
        write_s = time.perf_counter() - t
        prompts = [os.path.join(tmp, f"speaker{i + 1}.wav") for i in (0, 1)]
        for i, path in enumerate(prompts):
            save_wav(path, speech_like_wav(seed + 11 + i, seconds=3.0), 24000)
        print(f"dialog path: two model dirs written in {write_s:.2f} s; "
              f"prompts 2 x 3.00 s", flush=True)

        def load(name, model_dir, dtype):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model, tokenizer = load_model_dir(model_dir, name, dtype=dtype)
            torch.cuda.synchronize()
            return model, tokenizer, time.perf_counter() - t

        vocos = load_vocos(vocos_path, dtype=torch.bfloat16)
        for name, model_dir, cls in (
                ("zipvoice_dialog", mono_dir, DialogInferencePipeline),
                ("zipvoice_dialog_stereo", stereo_dir,
                 StereoDialogInferencePipeline)):
            model, tokenizer, load_s = load(name, model_dir, torch.bfloat16)
            n_params = sum(p.numel() for p in model.parameters())
            pipe = cls(model, vocos, seed=seed, tokenizer=tokenizer)
            stereo = cls is StereoDialogInferencePipeline
            generate = (pipe.generate_dialog_stereo if stereo
                        else pipe.generate_dialog)

            def request():
                return generate(DIALOG_PROMPT_TEXTS, prompts, DIALOG_TEXT,
                                **kw)

            request()  # first touch of the bucket, not counted
            (wav, m), n, _ = counted(card, name, model, num_step, request)
            launches[name] = n
            if not any(T == 1280 for _, _, T in pipe._seen_buckets):
                raise AssertionError(f"{name}: no request at the 1280-frame "
                                     f"bucket: {pipe._seen_buckets}")
            if stereo:
                check_stereo_wav(name, wav, m["frames"])
            else:
                check_wav(name, wav, m["frames"])
            print(f"{name}: load_model_dir in bf16 to the card {load_s:.2f} "
                  f"s ({n_params / 1e6:.1f}M params); chunks of "
                  f"{m['chunk_tokens']} tokens, {m['frames']} frames, wav "
                  f"{wav.shape}, {m['wav_seconds']:.3f} s; front end "
                  f"{m['t_frontend'] * 1e3:.1f} ms on the host; t "
                  f"{m['t']:.4f} s (t_vocoder {m['t_vocoder']:.4f}), rtf "
                  f"{m['rtf']:.4f}, bf16, {num_step} steps [{card}]",
                  flush=True)
            del model, pipe
            torch.cuda.empty_cache()

        # the stereo request in f32 with #1 and on the plain path
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model, tokenizer, _ = load("zipvoice_dialog_stereo", stereo_dir,
                                   torch.float32)
        feats = {}
        for use_kernel in (True, False):
            set_attention_kernel(model, use_kernel)
            pipe = StereoDialogInferencePipeline(model, vocos, seed=seed,
                                                 tokenizer=tokenizer)
            inner = pipe._sample_batch

            def keep(*args, _inner=inner, _on=use_kernel, **kwargs):
                f, lens = _inner(*args, **kwargs)
                feats[_on] = f[0, : lens[0]]
                return f, lens

            pipe._sample_batch = keep
            pipe.generate_dialog_stereo(DIALOG_PROMPT_TEXTS, prompts,
                                        DIALOG_TEXT, **kw)
        if feats[True].shape != feats[False].shape:
            raise AssertionError(f"stereo f32 shapes {feats[True].shape} "
                                 f"and {feats[False].shape}")
        d = float(np.abs(feats[True] - feats[False]).max())
        print(f"zipvoice_dialog_stereo f32, TF32 off: features "
              f"{feats[True].shape} with #1 vs the plain path, mel max|d| "
              f"{d:.3e} (tol {PATH_ATOL:.0e}) [{card}]", flush=True)
        if not d <= PATH_ATOL:
            raise AssertionError(f"stereo kernel path disagrees: {d}")
        del model, pipe
        torch.cuda.empty_cache()

        # the CLI: mono in this process, stereo as a subprocess
        out = os.path.join(tmp, "mono.wav")
        t = time.perf_counter()
        rc, log = run_dialog_cli([
            "--model-name", "zipvoice_dialog", "--model-dir", mono_dir,
            "--vocoder-path", vocos_path, "--bf16",
            "--prompt-text-1", DIALOG_PROMPT_TEXTS[0],
            "--prompt-wav-1", prompts[0],
            "--prompt-text-2", DIALOG_PROMPT_TEXTS[1],
            "--prompt-wav-2", prompts[1], "--text", DIALOG_TEXT,
            "--res-wav-path", out])
        mono_s = time.perf_counter() - t
        rtf = [line for line in log if "rtf" in line]
        print(f"dialog CLI in process (zipvoice_dialog): exit {rc} in "
              f"{mono_s:.1f} s; " + " | ".join(rtf) + f" [{card}]",
              flush=True)
        if rc != 0 or not rtf:
            raise AssertionError(f"dialog CLI: exit {rc}, log {log}")
        if read_wav_header(out)[:2] != (24000, 1):
            raise AssertionError(f"dialog CLI wav {read_wav_header(out)}")

        res = os.path.join(tmp, "res")
        test_list = os.path.join(tmp, "dialog.tsv")
        with open(test_list, "w", encoding="utf-8") as f:
            f.write("\t".join(["stereo", *DIALOG_PROMPT_TEXTS, *prompts,
                               DIALOG_TEXT]) + "\n")
        t = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "zipvoice_torch.bin.infer_zipvoice_dialog",
             "--model-name", "zipvoice_dialog_stereo", "--model-dir",
             stereo_dir, "--vocoder-path", vocos_path, "--bf16",
             "--test-list", test_list, "--res-dir", res],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
            capture_output=True, text=True, timeout=600,
        )
        cli_s = time.perf_counter() - t
        log = [line for line in r.stderr.splitlines() if "rtf" in line]
        print(f"dialog CLI subprocess (zipvoice_dialog_stereo): exit "
              f"{r.returncode} in {cli_s:.1f} s; "
              + " | ".join(line.split(":", 2)[-1].strip() for line in log)
              + f" [{card}]", flush=True)
        if r.returncode != 0:
            raise AssertionError(f"dialog CLI failed:\n{r.stderr[-4000:]}")
        if len(log) < 2:
            raise AssertionError(f"dialog CLI logged no rtf:\n"
                                 f"{r.stderr[-4000:]}")
        sr, ch, n = read_wav_header(os.path.join(res, "stereo.wav"))
        if (sr, ch) != (24000, 2) or n == 0:
            raise AssertionError(f"dialog CLI stereo wav: {sr} Hz, {ch} "
                                 f"channel(s), {n} frames")
    finally:
        shutil.rmtree(tmp)
    return launches


# phase 13: the server at ZipVoice-Distill's defaults (4 steps, guidance
# 3.0).  Four speakers, prefixes of one 3 s prompt as the client makes them
# (3.0, 2.64, 2.28, 1.92 s; 254, 237, 205 and 172 frames once trimmed, 45
# prompt tokens each), and four texts of 151, 159, 143 and 181 tokens, the
# client sending text i to speaker i: speakers 0 and 1 land in the
# 1280-frame bucket (about 1107 and 1075 frames), 2 and 3 in the 1024 one
# (about 857 and 864), at S=256 (192 for text 2 alone).  Shorter texts
# after the shorter prompts would fall to 768, where #1 runs at one level.
SERVE_NUM_STEP = 4
SERVE_GUIDANCE = 3.0
SERVE_TEXTS = [
    "Across the valley, the old mill still turns when the spring rains "
    "come, and the miller keeps warm bread on the stone sill for all the "
    "tired travelers.",
    "Travelers who stop by the mill are offered warm bread and a seat by "
    "the fire, while the river runs loud and fast below the great turning "
    "wheel of oak.",
    "The children of the village gather by the water every evening to "
    "watch the swallows, count the passing boats and race their little "
    "paper ships.",
    "When winter comes at last, the great wheel stands still and quiet, and "
    "the whole valley waits under deep snow for the first warm wind of the "
    "new year to blow down the hills.",
]
SERVE_WARM = [(b, s, t) for b in (1, 2, 4, 8)
              for s, t in ((256, 1280), (256, 1024), (192, 1024))]
# int8 against bf16 on the same noise: mean relative |d| of the features
# (tests/test_quantize.py's bound), and the weight bytes held on the card.
# The allocator's peak across one request is held to bf16's plus the int8
# bytes: the expanded copy lives for one call at a time, so int8's peak
# may exceed bf16's by no more than its own weights.
INT8_REL_TOL = 0.15
INT8_BYTES_RATIO = 0.6
# the first /tts after the engine's warm-up against the same request sent
# again: its vocode_ms within this multiple of their median
SERVE_VOCODE_REPEATS = 4
FIRST_VOCODE_RATIO = 2.0


def check_served_wav(what, data):
    """A 16-bit wav of one 24 kHz channel, non-empty, finite and within
    [-1, 1]: (seconds of audio)."""
    import io
    import wave

    with wave.open(io.BytesIO(data), "rb") as f:
        head = (f.getframerate(), f.getnchannels(), f.getsampwidth())
        pcm = np.frombuffer(f.readframes(f.getnframes()), "<i2")
    return check_served_pcm(what, pcm, head)


def check_served_pcm(what, pcm, head=(24000, 1, 2)):
    wav = pcm.astype(np.float32) / 32768.0
    if head != (24000, 1, 2) or wav.size == 0:
        raise AssertionError(f"{what}: (rate, channels, width) {head}, "
                             f"{wav.size} samples")
    if not (np.isfinite(wav).all() and np.abs(wav).max() <= 1.0):
        raise AssertionError(f"{what}: wav not finite or outside [-1, 1]")
    return wav.size / 24000


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http(url, path, obj=None):
    """(status, content type, body) of a GET, or of a POST of ``obj`` as
    JSON; an error status is returned, not raised."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url + path, data=None if obj is None else json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def phase_serving(card, seed):
    """The server at full width: a ZipVoice-Distill model dir (published
    widths, random weights from ``seed``) and a random Vocos, loaded in
    bf16, behind ``TTSEngine`` (max_batch 8, 4 steps, guidance 3.0) and
    ``make_handler`` on a thread; every route; the port's client as a
    subprocess at concurrency 1 and 8 over four speakers, its micro-batches
    and #1's launches recorded; the engine against ``_sample_batch``; the
    int8 pipeline's weight bytes and features against bf16's; then the
    server's entry point as a subprocess.  Returns #1's launches in the
    served traffic."""
    import base64
    import shutil
    import subprocess
    import tempfile
    import threading
    from http.server import ThreadingHTTPServer

    import torch

    from zipvoice_torch.bin.make_model_dir import BASE_CONFIG, make_model_dir
    from zipvoice_torch.frontend.audio import save_wav
    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.infer.workload import speech_like_wav
    from zipvoice_torch.serving import client, server
    from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos

    start = time.perf_counter()
    name = "zipvoice_distill"
    kw = dict(num_step=SERVE_NUM_STEP, guidance_scale=SERVE_GUIDANCE)
    tmp = tempfile.mkdtemp(prefix="zipvoice_serve_")
    proc = None
    try:
        make_model_dir(tmp, name, config=BASE_CONFIG, seed=seed,
                       vocos_config={})
        vocos_path = os.path.join(tmp, "pytorch_model.bin")
        prompt = os.path.join(tmp, "prompt.wav")
        save_wav(prompt, speech_like_wav(seed, seconds=3.0), 24000)
        texts = os.path.join(tmp, "texts.txt")
        with open(texts, "w", encoding="utf-8") as f:
            f.write("\n".join(SERVE_TEXTS) + "\n")

        def load(quantize=None):
            model, tok = load_model_dir(tmp, name, dtype=torch.bfloat16)
            vocos = load_vocos(vocos_path, dtype=torch.bfloat16)
            return InferencePipeline(model, vocos, seed=seed, tokenizer=tok,
                                     quantize=quantize)

        # nothing of an earlier phase may be freed inside the measurement
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        pipe = load()
        torch.cuda.synchronize()
        held16 = torch.cuda.memory_allocated() - before
        model = pipe.model
        engine = server.TTSEngine(pipe, max_batch=8, **kw)
        # warmed through the engine's own threads and streams, as the
        # server's --warmup does
        for B, S, T in SERVE_WARM:
            engine.warm(B, S, T)
        torch.cuda.synchronize()
        print(f"serving: {name} and Vocos in bf16, {len(SERVE_WARM)} "
              f"buckets warmed through the engine, "
              f"{time.perf_counter() - start:.1f} s into the phase [{card}]",
              flush=True)

        httpd = ThreadingHTTPServer(("127.0.0.1", 0),
                                    server.make_handler(engine, name))
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        # test hooks: each sample call's rows and prompt lengths, each
        # bucket the model ran, and each batch handed to the finisher
        calls, batches = [], []
        sample_device = pipe._sample_batch_device

        def spy(batch_tokens, prompt_tokens, prompt_features, **k):
            calls.append([f.shape[0] for f in prompt_features])
            return sample_device(batch_tokens, prompt_tokens,
                                 prompt_features, **k)

        pipe._sample_batch_device = spy
        hand_off = engine._inflight.put

        def keep_batch(got, *a, **k):
            if got is not None:
                batches.append([item[-1] for item in got[0]])
            return hand_off(got, *a, **k)

        engine._inflight.put = keep_batch
        dispatched = record_dispatches(model)
        torch.cuda.synchronize()
        reset_launches()
        try:
            code, _, body = http(url, "/health")
            if (code, json.loads(body)) != (200, {"status": "ok"}):
                raise AssertionError(f"/health: {code} {body!r}")
            code, _, body = http(url, "/v1/models")
            if code != 200 or json.loads(body)["data"][0]["id"] != name:
                raise AssertionError(f"/v1/models: {code} {body!r}")
            for i, data in enumerate(client.prompt_prefixes(prompt, 4)):
                code, _, body = http(url, "/speaker", {
                    "name": f"spk{i}", "prompt_text": CLI_PROMPT_TEXT,
                    "prompt_wav_b64": base64.b64encode(data).decode()})
                if code != 200:
                    raise AssertionError(f"/speaker: {code} {body!r}")
            with open(prompt, "rb") as f:
                prompt_b64 = base64.b64encode(f.read()).decode()
            cached = {"speaker": "spk0", "text": SERVE_TEXTS[0]}
            vocode_ms = []
            for what, req in (
                    ("cached speaker", cached),
                    ("inline prompt", {"prompt_text": CLI_PROMPT_TEXT,
                                       "prompt_wav_b64": prompt_b64,
                                       "text": SERVE_TEXTS[2]}),
                    *[(f"cached speaker, again ({i})", cached)
                      for i in range(1, 1 + SERVE_VOCODE_REPEATS)]):
                code, _, body = http(url, "/tts", req)
                out = json.loads(body)
                if code != 200 or min(out["timing"].values()) < 0:
                    raise AssertionError(f"/tts {what}: {code} {out}")
                seconds = check_served_wav(
                    f"/tts {what}", base64.b64decode(out["wav_b64"]))
                print(f"/tts ({what}): {seconds:.3f} s of audio, latency "
                      f"{out['latency_s']:.4f} s, phases (ms) "
                      + ", ".join(f"{k} {v:.1f}"
                                  for k, v in out["timing"].items())
                      + f" [{card}]", flush=True)
                if req is cached:
                    vocode_ms.append(out["timing"]["vocode_ms"])
            # the first request through the warmed engine pays no stall:
            # its vocoding within 2x the later identical requests' median
            rest = float(np.median(vocode_ms[1:]))
            print(f"first /tts vocode_ms {vocode_ms[0]:.2f} vs the median of "
                  f"the {len(vocode_ms) - 1} identical requests after it "
                  f"{rest:.2f} ({vocode_ms[0] / rest:.2f}x, limit "
                  f"{FIRST_VOCODE_RATIO}x) [{card}]", flush=True)
            if not vocode_ms[0] <= FIRST_VOCODE_RATIO * rest:
                raise AssertionError(f"first vocode {vocode_ms[0]} ms vs "
                                     f"{rest} ms: the warm-up left it cold")
            for fmt in ("wav", "pcm"):
                code, ctype, body = http(url, "/v1/audio/speech", {
                    "model": name, "input": SERVE_TEXTS[1], "voice": "spk1",
                    "response_format": fmt})
                if (code, ctype) != (200, f"audio/{fmt}"):
                    raise AssertionError(f"/v1/audio/speech {fmt}: {code} "
                                         f"{ctype} {body[:200]!r}")
                if fmt == "wav":
                    check_served_wav("/v1/audio/speech wav", body)
                else:
                    check_served_pcm("/v1/audio/speech pcm",
                                     np.frombuffer(body, "<i2"))
            code, _, body = http(url, "/v1/audio/speech",
                                 {"input": "x", "voice": "nobody"})
            if code != 404 or "unknown voice" not in body.decode():
                raise AssertionError(f"unknown voice: {code} {body!r}")
            print(f"serving routes: /health, /v1/models, /speaker x4, /tts "
                  f"cached and inline, /v1/audio/speech wav and pcm, 404 "
                  f"for an unknown voice [{card}]", flush=True)

            n_routes, n_batches = len(calls), len(batches)
            t = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "zipvoice_torch.serving.client",
                 "--url", url, "--prompt-wav", prompt, "--prompt-text",
                 CLI_PROMPT_TEXT, "--text-file", texts, "--num-speakers",
                 "4", "--concurrency", "1,8", "--num-requests", "16"],
                cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                capture_output=True, text=True, timeout=600)
            client_s = time.perf_counter() - t
        finally:
            del model.sample, pipe._sample_batch_device, engine._inflight.put
        torch.cuda.synchronize()
        launched = launch_counts()
        if r.returncode != 0:
            raise AssertionError(f"client failed:\n{r.stderr[-4000:]}")
        sweep = [line.split("INFO:root:", 1)[-1]
                 for line in r.stderr.splitlines()
                 if "concurrency" in line or "server phases" in line]
        print(f"client subprocess (4 speakers, 16 requests at c=1 and at "
              f"c=8, {SERVE_NUM_STEP} steps, bf16) in {client_s:.1f} s:",
              flush=True)
        for line in sweep:
            print(f"  {line} [{card}]", flush=True)
        if sum(line.startswith("concurrency") for line in sweep) != 2:
            raise AssertionError(f"client printed no sweep:\n"
                                 f"{r.stderr[-4000:]}")

        want = dict.fromkeys(launched, 0)
        for _, S, T in dispatched:
            for k, n in expected_launches(model, S, T,
                                          SERVE_NUM_STEP).items():
                want[k] += n
        traffic = calls[n_routes:]
        mixed = [c for c in traffic if len(c) > 1 and len(set(c)) > 1]
        buckets = sorted(set(dispatched))
        print(f"served micro-batches: {len(calls)} sample calls "
              f"({len(traffic)} from the client), rows per call "
              f"{[len(c) for c in traffic]}, {len(mixed)} of them with rows "
              f"of 2+ speakers (prompt frames {mixed[:3]}...); buckets "
              f"(B, S, T) {buckets}; launches "
              f"{ {k: v for k, v in launched.items() if v} } (expected "
              f"{ {k: v for k, v in want.items() if v} }) [{card}]",
              flush=True)
        if not mixed:
            raise AssertionError(f"no micro-batch of several speakers: "
                                 f"{traffic}")
        if launched != want or launched["rel_pos_attention_weights"] <= 0:
            raise AssertionError(f"serving launches {launched}, want {want}")
        if not {T for _, _, T in dispatched} >= {1024, 1280}:
            raise AssertionError(f"buckets {buckets}: not 1024 and 1280")
        launches = launched["rel_pos_attention_weights"]

        # the stages' overlap in the client's traffic, from the engine's own
        # stamps: of the consecutive batches N, N+1 where a request of N+1
        # was waiting before N was vocoded (none at c=1), those whose
        # sample started before N was vocoded
        client_batches = batches[n_batches:]
        pairs = [(n[0]["vocoded"], m[0]["dispatch"], m[0]["dispatched"])
                 for n, m in zip(client_batches, client_batches[1:])
                 if min(tm["submit"] for tm in m) < n[0]["vocoded"]]
        over = [p for p in pairs if p[1] < p[0]]
        if pairs:
            print(f"stage overlap: {len(over)} of the {len(pairs)} "
                  f"consecutive batches N, N+1 with N+1 waiting before N was "
                  f"vocoded started N+1's sample first; vocoded(N) - "
                  f"dispatch(N+1) median "
                  f"{np.median([v - d for v, d, _ in pairs]) * 1e3:.1f} ms, "
                  f"vocoded(N) - dispatched(N+1) median "
                  f"{np.median([v - d for v, _, d in pairs]) * 1e3:.1f} ms "
                  f"[{card}]", flush=True)
        else:
            print(f"stage overlap: no batch waited on another [{card}]",
                  flush=True)
        httpd.shutdown()
        httpd.server_close()
        engine.close()

        # the engine against _sample_batch on a fresh pipeline, same seed
        entry = engine.cache.get("spk0")
        tokens = pipe.tokenizer.texts_to_token_ids([SERVE_TEXTS[0]])[0]
        pipe.rng = np.random.RandomState(seed)
        read = []
        vocode = pipe._vocode_chunks

        def keep_feats(chunks):
            read.extend(chunks)
            return vocode(chunks)

        pipe._vocode_chunks = keep_feats
        engine = server.TTSEngine(pipe, max_batch=8, **kw)
        status, _, _ = engine.submit(entry, SERVE_TEXTS[0]).get(timeout=300)
        engine.close()
        del pipe._vocode_chunks
        fresh = InferencePipeline(model, pipe.vocoder, seed=seed,
                                  tokenizer=pipe.tokenizer)
        feats, lens = fresh._sample_batch(
            [tokens], [entry["tokens"]], [entry["features"]], speed=[1.0],
            t_shift=0.5, **kw)
        want_feats = feats[0, : lens[0]]
        if status != "ok" or read[0].shape != want_feats.shape:
            raise AssertionError(f"engine request {status}, features "
                                 f"{read[0].shape if read else None} vs "
                                 f"{want_feats.shape}")
        d = float(np.abs(read[0] - want_feats).max())
        print(f"engine vs _sample_batch on a fresh pipeline, same seed: "
              f"features {want_feats.shape}, mel max|d| {d:.3e} (tol "
              f"{PATH_ATOL:.0e}) [{card}]", flush=True)
        if not d <= PATH_ATOL:
            raise AssertionError(f"engine and pipeline disagree: {d}")

        # int8: the weights held on the card, and the allocator's peak
        # across one request (sample and vocode), each against bf16's
        bf16_bytes = pipe.weight_bytes()
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        pipe8 = load("int8")
        torch.cuda.synchronize()
        held8 = torch.cuda.memory_allocated() - before
        int8_bytes = pipe8.weight_bytes()
        args = ([tokens], [entry["tokens"]], [entry["features"]])
        sample_kw = dict(speed=[1.0], t_shift=0.5, **kw)

        def request(p):
            """(features, lengths, allocator bytes above the base at the
            request's peak) of one request on ``p`` from ``seed``'s noise,
            #1 counted."""
            p.rng = np.random.RandomState(seed)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            feats, lens = p._sample_batch(*args, **sample_kw)
            p._vocode_chunks([feats[0, : lens[0]]])
            torch.cuda.synchronize()
            return feats, lens, torch.cuda.max_memory_allocated() - base

        want8, _, peak16 = request(pipe)
        reset_launches()
        got8, lens8, peak8 = request(pipe8)
        n8 = launch_counts()["rel_pos_attention_weights"]
        n = lens8[0]
        rel = float(np.abs(got8[0, :n] - want8[0, :n]).mean()
                    / np.abs(want8[0, :n]).mean())
        foot16, foot8 = held16 + peak16, held8 + peak8
        mib = 2 ** 20
        print(f"int8: weights on the card {int8_bytes / mib:.1f} MiB vs "
              f"bf16 {bf16_bytes / mib:.1f} MiB "
              f"({int8_bytes / bf16_bytes:.3f}x, limit {INT8_BYTES_RATIO}); "
              f"allocator peak across one request (weights held plus the "
              f"request's peak above them) int8 {foot8 / mib:.1f} MiB "
              f"({held8 / mib:.1f} + {peak8 / mib:.1f}) vs bf16 "
              f"{foot16 / mib:.1f} MiB ({held16 / mib:.1f} + "
              f"{peak16 / mib:.1f}): {foot8 / foot16:.3f}x ({foot8} vs "
              f"{foot16} bytes; limits: below bf16's, and at most bf16's "
              f"plus int8's own {held8 / mib:.1f} MiB), the stack-at-a-time "
              f"expansion included; features vs bf16 on the same "
              f"noise: mean relative |d| {rel:.4f} (tol {INT8_REL_TOL}); "
              f"#1 launches {n8} [{card}]", flush=True)
        if not int8_bytes < INT8_BYTES_RATIO * bf16_bytes:
            raise AssertionError(f"int8 weights {int8_bytes} vs bf16 "
                                 f"{bf16_bytes}")
        if not foot8 <= foot16 + held8:
            raise AssertionError(f"int8 peak {foot8} above bf16's {foot16} "
                                 f"by more than one int8 copy {held8}")
        if not foot8 < foot16:
            raise AssertionError(f"int8 held plus peak {foot8} bytes not "
                                 f"below bf16's {foot16}")
        if not rel < INT8_REL_TOL or n8 <= 0:
            raise AssertionError(f"int8: relative |d| {rel}, #1 {n8}")

        # the sample's wall at this bucket: int8 expands each fm_decoder
        # stack in every Euler step (a launch for each group of its
        # tensors), bf16 has its weights
        def sample_wall(p):
            p.rng = np.random.RandomState(seed)
            torch.cuda.synchronize()
            t = time.perf_counter()
            p._sample_batch(*args, **sample_kw)
            torch.cuda.synchronize()
            return time.perf_counter() - t

        walls = {"bf16": [], "int8": []}
        for order in (("bf16", "int8"), ("int8", "bf16")) * 5:
            for which in order:
                walls[which].append(sample_wall(
                    pipe8 if which == "int8" else pipe))
        w16, w8 = (float(np.median(walls[k])) for k in ("bf16", "int8"))
        print(f"int8 vs bf16 sample wall at bucket "
              f"{sorted(pipe8._seen_buckets)}, {SERVE_NUM_STEP} steps, "
              f"alternating: int8 median {1e3 * w8:.2f} ms (" + ", ".join(
                  f"{1e3 * x:.2f}" for x in walls["int8"]) + f"), bf16 "
              f"median {1e3 * w16:.2f} ms (" + ", ".join(
                  f"{1e3 * x:.2f}" for x in walls["bf16"]) + f"): "
              f"{w8 / w16:.3f}x [{card}]", flush=True)
        del pipe, pipe8, fresh, model
        torch.cuda.empty_cache()

        # the entry point as a subprocess
        port = free_port()
        t = time.perf_counter()
        with open(os.path.join(tmp, "server.log"), "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "zipvoice_torch.serving.server",
                 "--model-dir", tmp, "--vocoder-path", vocos_path,
                 "--port", str(port), "--warmup-buckets", "1:256:1280"],
                cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                stdout=log, stderr=subprocess.STDOUT)
        url = f"http://127.0.0.1:{port}"
        deadline = time.perf_counter() + 300
        while True:
            if proc.poll() is not None:
                raise AssertionError(
                    f"server exited {proc.returncode}:\n"
                    + open(os.path.join(tmp, "server.log")).read()[-4000:])
            try:
                if http(url, "/health")[0] == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() > deadline:
                raise AssertionError("server did not come up in 300 s")
            time.sleep(0.5)
        up_s = time.perf_counter() - t
        code, _, body = http(url, "/tts", {
            "prompt_text": CLI_PROMPT_TEXT, "prompt_wav_b64": prompt_b64,
            "text": SERVE_TEXTS[0]})
        if code != 200:
            raise AssertionError(f"server CLI /tts: {code} {body[:400]!r}")
        out = json.loads(body)
        seconds = check_served_wav("server CLI /tts",
                                   base64.b64decode(out["wav_b64"]))
        print(f"server CLI subprocess: /health answered {up_s:.1f} s after "
              f"the start; /tts {seconds:.3f} s of audio in "
              f"{out['latency_s']:.4f} s [{card}]", flush=True)
    finally:
        if proc is not None and proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp)
    print(f"serving phase: {time.perf_counter() - start:.1f} s wall "
          f"[{card}]", flush=True)
    return launches, sweep


# phase 14: the trainer's entry points at the base's full width.  20
# utterances of 12.4-13.5 s (1163-1266 frames, all in the 1280-frame
# bucket, so every step's T and T/2 pass the gate of #4/#5): with
# --max-duration 110 and two duration buckets of 10, each bucket emits one
# batch of 8 when its ninth cut arrives and drops the last two (the
# trainer's drop_last), so an epoch is 2 steps at B=8, T=1280.  Fewer than
# 18 cuts would leave every bucket below the budget and the epoch empty.
TRAIN_CLI_UTTS = 20
TRAIN_CLI_SECONDS = (12.4, 13.5)


def gate_layers(config, S, T):
    """Layers whose attention weights take a kernel in one forward of a
    model with ``config``'s widths: each fm_decoder layer whose level
    (ceil(T / its factor)) reaches the gate, and each text-encoder layer
    when S does."""
    from zipvoice_torch.models.zipformer import MIN_SEQ_LEN

    n = sum(layers for ds, layers in zip(
        config["fm_decoder_downsampling_factor"],
        config["fm_decoder_num_layers"]) if -(-T // ds) >= MIN_SEQ_LEN)
    return n + config["text_encoder_num_layers"] * (S >= MIN_SEQ_LEN)


def print_steps(card, what, history):
    for h in history:
        B, S, T = h["shape"]
        print(f"  {what} step {h['step']} (epoch {h['epoch']}, B={B} S={S} "
              f"T={T}): loss {h['loss']:.4f}, wall {h['wall']:.4f} s, "
              f"{h['frames'] / h['wall']:.0f} frames/s [{card}]", flush=True)
    if not history or not all(np.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"{what}: losses {[h['loss'] for h in history]}")


def cli_launches(card, what, fn, want_fn):
    """Run ``fn`` (a CLI's ``main``) with every launch count at 0 just
    before it; the launches must equal ``want_fn(history)``.  Returns (the
    history, the launches, seconds)."""
    import torch

    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    history = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    launched = launch_counts()
    want = want_fn(history)
    print(f"{what}: {len(history)} steps in {seconds:.1f} s, launches "
          f"{ {k: v for k, v in launched.items() if v} } (the gates "
          f"predict { {k: v for k, v in want.items() if v} }) [{card}]",
          flush=True)
    if launched != want:
        raise AssertionError(f"{what}: launches {launched}, want {want}")
    return history, launched, seconds


def phase_train_cli(card, seed):
    """The trainer's entry points at the ZipVoice base's published widths
    (122.7M f32 parameters, bf16 compute): a synthetic corpus through
    ``bin/prepare_dataset`` and ``bin/compute_fbank`` (the native .fz
    codec), one epoch of ``bin/train_zipvoice``, a resumed second epoch,
    ``bin/generate_averaged_model`` and ``generate_sentence`` on its .pt,
    then both stages of ``bin/train_zipvoice_distill``, all in process,
    with the kernels' launches held to the gates' count.  Returns the
    launches of #1, #4 and #5 in the trainer and distillation runs."""
    import shutil
    import tempfile

    import torch

    from zipvoice_torch.bin import (
        compute_fbank,
        generate_averaged_model,
        prepare_dataset,
        train_zipvoice,
        train_zipvoice_distill,
    )
    from zipvoice_torch.bin.make_model_dir import BASE_CONFIG, emilia_tokens
    from zipvoice_torch.data import featio
    from zipvoice_torch.frontend.audio import save_wav
    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.infer.workload import speech_like_wav
    from zipvoice_torch.utils.checkpoint_io import load_model_dir
    from zipvoice_torch.vocoder.vocos import build_vocos

    start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="zipvoice_train_")
    out = {}
    try:
        with open(os.path.join(REPO, "tools", "data",
                               "en_stream_corpus.txt"),
                  encoding="utf-8") as f:
            texts = [line.strip() for line in f if line.strip()]
        seconds = np.linspace(*TRAIN_CLI_SECONDS, TRAIN_CLI_UTTS)
        rows = []
        for i, (text, sec) in enumerate(zip(texts, seconds)):
            wav = os.path.join(tmp, f"utt{i:02d}.wav")
            save_wav(wav, speech_like_wav(seed + i, seconds=float(sec)),
                     24000)
            rows.append(f"utt{i:02d}\t{text}\t{wav}")
        tsv = os.path.join(tmp, "train.tsv")
        with open(tsv, "w", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")
        tokens = os.path.join(tmp, "tokens.txt")
        with open(tokens, "w", encoding="utf-8") as f:
            f.write("".join(f"{t}\t{i}\n"
                            for i, t in enumerate(emilia_tokens())))
        t = time.perf_counter()
        manifest = prepare_dataset.main([
            "--tsv-path", tsv, "--prefix", "smoke", "--output-dir",
            os.path.join(tmp, "manifests")])
        n_feats = compute_fbank.main([
            "--manifest", manifest, "--output-dir",
            os.path.join(tmp, "fbank")])
        codec = featio.codec()
        print(f"train CLI: {TRAIN_CLI_UTTS} utterances of "
              f"{seconds[0]:.1f}-{seconds[-1]:.1f} s, prepare_dataset and "
              f"compute_fbank ({n_feats} .fz files, codec {codec}) in "
              f"{time.perf_counter() - t:.1f} s [{card}]", flush=True)
        if codec != "native" or n_feats != TRAIN_CLI_UTTS:
            raise AssertionError(f"fbank: codec {codec}, {n_feats} files")

        exp = os.path.join(tmp, "exp")
        common = ["--train-manifest", manifest, "--token-file", tokens,
                  "--tokenizer", "emilia", "--max-duration", "110",
                  "--num-buckets", "2", "--log-interval", "1",
                  "--seed", str(seed)]
        train = common + ["--model-name", "zipvoice", "--exp-dir", exp,
                          "--average-period", "1", "--save-every-n", "2"]

        def train_want(history):
            want = dict.fromkeys(launch_counts(), 0)
            for h in history:
                B, S, T = h["shape"]
                n = gate_layers(BASE_CONFIG, S, T)
                want["rel_pos_attention_weights_train"] += n
                want["rel_pos_attention_weights_bwd"] += n
            return want

        first, l1, s1 = cli_launches(
            card, "train_zipvoice --num-epochs 1",
            lambda: train_zipvoice.main(train + ["--num-epochs", "1"]),
            train_want)
        print_steps(card, "train", first)
        if not all(h["shape"][2] == 1280 for h in first) or any(
                gate_layers(BASE_CONFIG, *h["shape"][1:]) != 12
                for h in first):
            raise AssertionError(f"train batches {[h['shape'] for h in first]}"
                                 f": not all at T=1280 with 12 gated layers")

        resumed, l2, s2 = cli_launches(
            card, "train_zipvoice --start-epoch 2 --num-epochs 2",
            lambda: train_zipvoice.main(
                train + ["--start-epoch", "2", "--num-epochs", "2"]),
            train_want)
        print_steps(card, "resumed", resumed)
        args = train_zipvoice.get_parser().parse_args(train)
        sampler, _ = train_zipvoice.make_train_sampler(args)
        sampler.set_epoch(2)
        straight = [c.id for c in next(iter(sampler))]
        print(f"resume from epoch-1: steps {[h['step'] for h in first]} then "
              f"{[h['step'] for h in resumed]}; epoch 2's first batch "
              f"{resumed[0]['ids']} (an uninterrupted run's: {straight}) "
              f"[{card}]", flush=True)
        if resumed[0]["step"] != first[-1]["step"] + 1 or \
                resumed[0]["epoch"] != 2 or resumed[0]["ids"] != straight:
            raise AssertionError("resume did not carry on from epoch-1")

        t = time.perf_counter()
        avg_pt = generate_averaged_model.main(
            ["--exp-dir", exp, "--epoch", "2", "--avg", "2"])
        avg_s = time.perf_counter() - t
        model, tokenizer = load_model_dir(exp, "zipvoice",
                                          dtype=torch.bfloat16)
        vocos = build_vocos(dtype=torch.bfloat16, seed=seed + 1)
        pipe = InferencePipeline(model, vocos, seed=seed, tokenizer=tokenizer)
        prompt = os.path.join(tmp, "prompt.wav")
        save_wav(prompt, speech_like_wav(seed, seconds=3.0), 24000)
        pipe.generate_sentence(CLI_PROMPT_TEXT, prompt, CLI_TEXT,
                               num_step=16)  # first touch, not counted
        (wav, m), n1, _ = counted(
            card, "generate_sentence on the averaged model", model, 16,
            lambda: pipe.generate_sentence(CLI_PROMPT_TEXT, prompt, CLI_TEXT,
                                           num_step=16))
        check_wav("generate_sentence (averaged)", wav, m["frames"])
        print(f"generate_averaged_model --epoch 2 --avg 2 in {avg_s:.1f} s; "
              f"its .pt through load_model_dir: bucket(s) "
              f"{sorted(pipe._seen_buckets)}, "
              f"{m['wav_seconds']:.3f} s of wav, #1 launches {n1}, t "
              f"{m['t']:.4f} s [{card}]", flush=True)
        if pipe._seen_buckets != {(1, 192, 1280)} or n1 != 192:
            raise AssertionError(f"averaged model request: "
                                 f"{pipe._seen_buckets}, #1 {n1}")
        del model, vocos, pipe
        torch.cuda.empty_cache()

        def distill_want(history):
            want = dict.fromkeys(launch_counts(), 0)
            for h in history:
                B, S, T = h["shape"]
                n = gate_layers(BASE_CONFIG, S, T)
                want["rel_pos_attention_weights_train"] += n
                want["rel_pos_attention_weights_bwd"] += n
                # the teacher's two chained one-step solves
                want["rel_pos_attention_weights"] += 2 * n
            return want

        d1 = os.path.join(tmp, "distill1")
        stage1, ld1, _ = cli_launches(
            card, "train_zipvoice_distill --distill-stage first",
            lambda: train_zipvoice_distill.main(common + [
                "--exp-dir", d1, "--distill-stage", "first",
                "--teacher-checkpoint", avg_pt, "--num-iters", "2"]),
            distill_want)
        print_steps(card, "distill first", stage1)
        stage2, ld2, _ = cli_launches(
            card, "train_zipvoice_distill --distill-stage second",
            lambda: train_zipvoice_distill.main(common + [
                "--exp-dir", os.path.join(tmp, "distill2"),
                "--distill-stage", "second", "--checkpoint",
                os.path.join(d1, "checkpoint-2"), "--num-iters", "2"]),
            distill_want)
        print_steps(card, "distill second", stage2)
        # the steps after each run's first
        steady = first[1:] + resumed[1:]
        walls = [h["wall"] for h in steady]
        print(f"train CLI steps {[h['step'] for h in steady]} (after each "
              f"run's first): wall median {np.median(walls):.4f} s, "
              f"frames/s median "
              f"{np.median([h['frames'] / h['wall'] for h in steady]):.0f} "
              f"[{card}]", flush=True)
        out = {"train": {k: l1[k] + l2[k] for k in l1},
               "distill": {k: ld1[k] + ld2[k] for k in ld1},
               "step_wall": float(np.median(walls))}
    finally:
        shutil.rmtree(tmp)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"train CLI phase: {time.perf_counter() - start:.1f} s wall "
          f"[{card}]", flush=True)
    return out


# phase 16: multi-process training.  Spanish texts of 78-87 phonemes under
# the es G2P (S=96) for phase 14's synthetic utterances
ES_TEXTS = (
    "El viento del norte sopla con fuerza sobre las montañas y los valles.",
    "Mi abuela cocinaba una sopa de verduras todos los domingos por la "
    "tarde.",
    "Los niños juegan en el parque mientras sus padres conversan en un "
    "banco.",
    "La biblioteca de la ciudad abre sus puertas a las nueve de la mañana.",
    "Durante el verano viajamos a la costa para descansar junto al mar azul.",
    "El tren salió de la estación con veinte minutos de retraso esta noche.",
    "Ella escribe cartas a sus amigos que viven en otros países del mundo.",
    "Necesitamos comprar pan, leche y fruta fresca antes de volver a casa.",
    "El profesor explicó la lección con paciencia hasta que todos la "
    "entendieron.",
    "En otoño las hojas de los árboles cambian de color y caen al suelo.",
    "Mañana vamos a visitar el museo de arte moderno con toda la familia.",
    "La música de la orquesta llenó el teatro de una alegría muy especial.",
    "Después de la lluvia el cielo se despejó y apareció un arcoíris enorme.",
    "Mi hermano trabaja en un hospital y cuida a los enfermos cada noche.",
    "Los pescadores regresaron al puerto con las redes llenas de sardinas.",
    "El jardín de mi vecina tiene rosas rojas, lirios blancos y girasoles.",
    "Cada mañana camino por la playa y escucho el sonido tranquilo de las "
    "olas.",
    "La reunión empezó tarde porque el director no encontraba sus papeles.",
    "Aprender un idioma nuevo requiere práctica, tiempo y mucha curiosidad.",
    "Al final del camino encontramos una pequeña casa con un techo de tejas.",
)
FIRST_PARTY_VOICES = ("es", "de", "it", "ru", "nl", "pl", "pt", "fr")
MULTI_TIMEOUT = 600

# a subprocess: the trainer's entry point with every launch count at 0
# just before it; prints the history and the launches as its last line
TRAIN_SCRIPT = """
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
from zipvoice_torch.bin import train_zipvoice
chip_smoke.reset_launches()
history = train_zipvoice.main(sys.argv[2:])
print(json.dumps({"history": history,
                  "launches": chip_smoke.launch_counts()}))
"""

# a subprocess: process RANK of two on the card over gloo, two f32 steps of
# the full-width workload on its rows of the B=8 batch; saves its losses
# and parameters
PAIR_SCRIPT = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
from zipvoice_torch.parallel import mesh
from zipvoice_torch.train.workload import build_trainer, train_batch
rank, port, seed, out = (int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
                         sys.argv[5])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
mesh.init_distributed(f"127.0.0.1:{port}", 2, rank, "cuda", backend="gloo")
model, _, step = build_trainer(seed, torch.float32)
rows = mesh.local_batch_rows(rank, 2, 8)
batch = {k: v[rows[0]: rows[-1] + 1] for k, v in train_batch(seed).items()}
losses = [float(step(batch)["loss"]) for _ in range(2)]
torch.save({"losses": losses, "params": {
    k: v.cpu() for k, v in model.state_dict().items()}}, out)
mesh.destroy()
"""


def run_subprocess(what, argv, timeout=MULTI_TIMEOUT):
    """Run ``argv`` from the checkout's root; its stdout, or raise with its
    tail."""
    import subprocess

    proc = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"{what}: exit {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    return proc.stdout


def phase_multiprocess(card, seed, phase14_step_wall):
    """Multi-process training: the trainer CLI on a one-process NCCL group
    with the Spanish voice, then two processes over gloo on the one card
    against one process.  Returns #4's and #5's launches in the CLI run."""
    import shutil
    import subprocess
    import tempfile

    import torch

    from zipvoice_torch.bin import compute_fbank, prepare_dataset
    from zipvoice_torch.bin import build_tokens, prepare_tokens
    from zipvoice_torch.bin.make_model_dir import BASE_CONFIG
    from zipvoice_torch.frontend.audio import save_wav
    from zipvoice_torch.frontend.tokenizer import EspeakTokenizer
    from zipvoice_torch.infer.workload import speech_like_wav
    from zipvoice_torch.train.workload import build_trainer, train_batch

    start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="zipvoice_multi_")
    try:
        # (a) the Spanish corpus and the CLI on a one-process NCCL group
        counts = {v: sum(map(len, EspeakTokenizer(lang=v).texts_to_tokens(
            list(ES_TEXTS)))) for v in FIRST_PARTY_VOICES}
        print(f"multi-process: the {len(ES_TEXTS)} Spanish texts' tokens "
              f"under the eight first-party voices {counts}", flush=True)
        if min(counts.values()) <= 0:
            raise AssertionError(f"a voice gave no tokens: {counts}")
        seconds = np.linspace(*TRAIN_CLI_SECONDS, TRAIN_CLI_UTTS)
        rows = []
        for i, (text, sec) in enumerate(zip(ES_TEXTS, seconds)):
            wav = os.path.join(tmp, f"es{i:02d}.wav")
            save_wav(wav, speech_like_wav(seed + 100 + i, seconds=float(sec)),
                     24000)
            rows.append(f"es{i:02d}\t{text}\t{wav}")
        tsv = os.path.join(tmp, "train.tsv")
        with open(tsv, "w", encoding="utf-8") as f:
            f.write("\n".join(rows) + "\n")
        manifest = prepare_dataset.main([
            "--tsv-path", tsv, "--prefix", "es", "--output-dir",
            os.path.join(tmp, "manifests")])
        compute_fbank.main(["--manifest", manifest, "--output-dir",
                            os.path.join(tmp, "fbank")])
        prepare_tokens.main(["--manifest", manifest, "--tokenizer", "espeak",
                             "--lang", "es"])
        tokens = os.path.join(tmp, "tokens.txt")
        build_tokens.main(["--manifest", manifest, "--output", tokens])
        exp = os.path.join(tmp, "exp")
        argv = ["--train-manifest", manifest, "--token-file", tokens,
                "--tokenizer", "espeak", "--lang", "es", "--exp-dir", exp,
                "--max-duration", "110", "--num-buckets", "2",
                "--num-epochs", "1", "--log-interval", "1",
                "--average-period", "1", "--save-every-n", "0",
                "--seed", str(seed),
                "--coordinator-address", f"127.0.0.1:{free_port()}",
                "--num-processes", "1", "--process-id", "0",
                "--per-host-data", "on"]
        t = time.perf_counter()
        out = run_subprocess("train_zipvoice on an NCCL group", [
            sys.executable, "-c", TRAIN_SCRIPT, REPO, *argv])
        cli_s = time.perf_counter() - t
        result = json.loads(out.strip().splitlines()[-1])
        history, launched = result["history"], result["launches"]
        for h in history:
            h["shape"] = tuple(h["shape"])
        print_steps(card, "train (NCCL group of one, es)", history)
        want = dict.fromkeys(launched, 0)
        for h in history:
            n = gate_layers(BASE_CONFIG, *h["shape"][1:])
            want["rel_pos_attention_weights_train"] += n
            want["rel_pos_attention_weights_bwd"] += n
        print(f"train_zipvoice --tokenizer espeak --lang es on a one-process "
              f"NCCL group, as a subprocess: {len(history)} steps at "
              f"{sorted({h['shape'] for h in history})} in {cli_s:.1f} s; "
              f"launches { {k: v for k, v in launched.items() if v} } (the "
              f"gates predict { {k: v for k, v in want.items() if v} }); "
              f"step {history[-1]['step']} wall {history[-1]['wall']:.4f} s "
              f"against phase 14's {phase14_step_wall:.4f} s without a "
              f"group [{card}]", flush=True)
        if launched != want or len(history) != 2 or any(
                h["shape"] != (8, 96, 1280) for h in history):
            raise AssertionError(f"NCCL CLI run: {launched} vs {want}, "
                                 f"{[h['shape'] for h in history]}")
        for name in ("epoch-1", "epoch-1-avg", "model.json", "tokens.txt"):
            if not os.path.exists(os.path.join(exp, name)):
                raise AssertionError(f"process 0 did not write {name}")
        shutil.rmtree(exp)

        # (b) two processes on the card over gloo against one process
        port = free_port()
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", PAIR_SCRIPT, REPO, str(r), str(port),
             str(seed), outs[r]], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            tf32 = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            try:
                model, _, step = build_trainer(seed, torch.float32)
                batch = train_batch(seed)
                solo_losses = [float(step(batch)["loss"]) for _ in range(2)]
                solo = {k: v.detach().cpu()
                        for k, v in model.state_dict().items()}
                del model, step, batch
            finally:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = tf32
            for p in procs:
                o, e = p.communicate(timeout=MULTI_TIMEOUT)
                if p.returncode != 0:
                    raise AssertionError(f"gloo rank: exit {p.returncode}\n"
                                         f"{o[-2000:]}\n{e[-6000:]}")
        finally:
            for p in procs:
                p.kill()
        pair_s = time.perf_counter() - t
        ranks = [torch.load(o) for o in outs]
        worst_d, worst_ratio, worst_k = 0.0, 0.0, None
        for k, want_p in solo.items():
            got = ranks[0]["params"][k]
            if not torch.equal(got, ranks[1]["params"][k]):
                raise AssertionError(f"the two processes differ at {k}")
            d = (got.double() - want_p.double()).abs()
            ratio = float((d / (1e-5 + 1e-4 * want_p.double().abs())).max())
            worst_d = max(worst_d, float(d.max()))
            if ratio > worst_ratio:
                worst_ratio, worst_k = ratio, k
        loss_d = max(abs(a - b) / abs(b)
                     for a, b in zip(ranks[0]["losses"], solo_losses))
        print(f"two processes on one card over gloo (f32, B=8 as 4 + 4, "
              f"two steps) against one process at B=8: losses "
              f"{ranks[0]['losses']} against {solo_losses} (largest "
              f"relative |d| {loss_d:.3e}), parameters' largest |d| "
              f"{worst_d:.3e}, at most {worst_ratio:.3f} of atol 1e-5 + "
              f"rtol 1e-4 ({worst_k}); the processes' parameters equal bit "
              f"for bit; {pair_s:.1f} s (NCCL takes one process a device, "
              f"so two processes share the card over gloo) [{card}]",
              flush=True)
        if loss_d > 1e-5 or worst_ratio > 1.0:
            raise AssertionError("two processes do not match one")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"multi-process phase: {time.perf_counter() - start:.1f} s wall "
          f"[{card}]", flush=True)
    return {k: v for k, v in launched.items()}


# phase 15: the exported engines.  The base at phase 11's bucket (its
# prompt and text), bf16 and f32, and in the same directory at phase 3's
# B=8 bucket, (8, 192, 1280), timed against the eager request; the kernel
# configuration at (8, 256, 1280); ZipVoice-Distill at the three B=1
# buckets of phase 13's c=1 traffic behind the server's --engine-dir
ENGINE_BASE_BUCKET = (1, 192, 1280)
ENGINE_CONFIG_BUCKET = (8, 256, 1280)
ENGINE_B8_BUCKET = (8, 192, 1280)
ENGINE_SERVE_BUCKETS = ((1, 256, 1280), (1, 256, 1024), (1, 192, 1024))
ENGINE_WALL_REPEATS = 10


def engine_inputs(model, B, S, T, seed):
    """Seeded ``sample`` inputs at one bucket on the card: 3 s prompts
    (281 frames, 30 tokens) and texts that fill the bucket's frames."""
    import torch

    rng = np.random.RandomState(seed)
    F = model.feat_dim
    tok = np.zeros((B, S), np.int64)
    tok[:, :S - 20] = rng.randint(3, 300, (B, S - 20))
    pf = np.zeros((B, T, F), np.float32)
    pf[:, :281] = 0.5 * rng.randn(B, 281, F)
    return [torch.from_numpy(a).cuda() for a in (
        tok, np.full((B,), S - 19), np.full((B,), 30), pf,
        np.full((B,), 281), np.full((B,), T - 60),
        rng.randn(B, T, F).astype(np.float32))]


def engine_stats(card, what, manifest, bucket, engine):
    b = next(b for b in manifest["buckets"]
             if (b["B"], b["S"], b["T"]) == bucket)
    st = engine.stats
    print(f"{what} engine {b['B']}x{b['S']}x{b['T']}: export "
          f"{b['export_s']:.1f} s, files {b['bytes'] / 2 ** 20:.2f} MiB, "
          f"load {st['load_s']:.1f} s, capture {st['capture_s']:.2f} s, "
          f"graph pool {st['pool_bytes'] / 2 ** 20:.1f} MiB, "
          f"{st['graph_nodes']} graph nodes [{card}]", flush=True)


def replay_check(card, what, model, engine, x, num_step):
    """The engine's programs uncaptured with every count at 0 first (the
    launches must be what the gates predict), then captured and replayed:
    bit for bit the uncaptured output.  Returns (launches, x1)."""
    import torch

    S, T = x[0].shape[1], x[3].shape[1]
    torch.cuda.synchronize()
    reset_launches()
    with torch.inference_mode():
        want = [t.clone() for t in engine.run(*x)]
        torch.cuda.synchronize()
        launched = launch_counts()
        expected = expected_launches(model, S, T, num_step)
        engine.prepare(*x)
        reset_launches()
        got = engine(*x)
        torch.cuda.synchronize()
        replay_launches = sum(launch_counts().values())
        same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"{what}: uncaptured launches "
          f"{ {k: v for k, v in launched.items() if v} } (expected "
          f"{ {k: v for k, v in expected.items() if v} }), replay counts "
          f"{replay_launches}, replay equals the uncaptured program bit for "
          f"bit: {same} [{card}]", flush=True)
    if launched != expected or not any(launched.values()):
        raise AssertionError(f"{what}: launches {launched}, want {expected}")
    if not same or replay_launches:
        raise AssertionError(f"{what}: the replay differs from the "
                             f"uncaptured program")
    return launched, want[0]


def direct_capture(card, model, engine, x, num_step):
    """The design the engines are weighed against: eager ``model.sample``
    captured as one CUDA graph at the engine's bucket, with nothing
    exported or loaded.  Prints its capture seconds and pool bytes, whether
    its replay equals the engine's bit for bit, and both replays' median
    walls, alternating."""
    import torch

    kw = dict(num_step=num_step, guidance_scale=1.0, t_shift=0.5)
    start = time.perf_counter()
    static = [t.clone() for t in x]
    with torch.inference_mode():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            model.sample(*static, **kw)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = model.sample(*static, **kw)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - start
        pool = torch.cuda.memory_reserved() - reserved
        walls = {"engine": [], "direct": []}
        for i in range(ENGINE_WALL_REPEATS):
            for which in (("engine", "direct") if i % 2 else
                          ("direct", "engine")):
                torch.cuda.synchronize()
                t = time.perf_counter()
                if which == "engine":
                    got = engine(*x)
                else:
                    graph.replay()
                torch.cuda.synchronize()
                walls[which].append(time.perf_counter() - t)
        same = all(torch.equal(a, b) for a, b in zip(out, got))
    we, wd = (float(np.median(walls[k])) for k in ("engine", "direct"))
    print(f"direct capture of eager sample at the base bucket (no export, "
          f"no load): capture {capture_s:.2f} s (one eager run + capture), "
          f"graph pool {pool / 2 ** 20:.1f} MiB, replay equals the engine's "
          f"bit for bit: {same}; replay median {wd * 1e3:.2f} ms against "
          f"the engine's {we * 1e3:.2f} ms ({ENGINE_WALL_REPEATS} each, "
          f"alternating) [{card}]", flush=True)
    del graph, out
    torch.cuda.empty_cache()


def wait_export(card, what, proc, log_path, out_dir):
    """Wait for an export_model subprocess; its manifest."""
    if proc.wait(timeout=900) != 0:
        with open(log_path) as f:
            raise AssertionError(f"{what} export failed:\n{f.read()[-4000:]}")
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    for b in manifest["buckets"]:
        print(f"{what} export (bin/export_model subprocess) "
              f"{b['B']}x{b['S']}x{b['T']}: {b['export_s']:.1f} s, files "
              f"{b['bytes'] / 2 ** 20:.2f} MiB [{card}]", flush=True)
    return manifest


def phase_engines(card, seed, eager_sweep):
    """The exported engines on the card: ``bin/export_model`` and
    ``bin/infer_exported`` on the base, its replay against its uncaptured
    programs and against eager sampling (bf16, and f32 within PATH_ATOL),
    the kernel configuration's engine, the B=8 request replayed against
    eager, and the server's ``--engine-dir`` under phase 13's client.
    Returns the launches: #1's in the CLI path and uncaptured, the kernel
    configuration's uncaptured."""
    import logging
    import shutil
    import subprocess
    import tempfile

    import torch

    from zipvoice_torch.bin import infer_exported
    from zipvoice_torch.bin.make_model_dir import BASE_CONFIG, make_model_dir
    from zipvoice_torch.frontend.audio import load_wav, save_wav
    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.infer.workload import (
        micro_batches,
        run_request,
        speech_like_wav,
    )
    from zipvoice_torch.models.zipformer import set_kernel_config
    from zipvoice_torch.serving.aot import (
        export_sample_program,
        load_engine_dir,
    )
    from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos

    start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="zipvoice_engines_")
    procs = []
    try:
        base, distill = (os.path.join(tmp, n) for n in ("base", "distill"))
        make_model_dir(base, config=BASE_CONFIG, seed=seed, vocos_config={})
        make_model_dir(distill, "zipvoice_distill", config=BASE_CONFIG,
                       seed=seed, vocos_config={})
        prompt = os.path.join(tmp, "prompt.wav")
        save_wav(prompt, speech_like_wav(seed, seconds=3.0), 24000)

        def bucket_arg(buckets):
            return ",".join(":".join(map(str, b)) for b in buckets)

        def export_cli(model_dir, out, buckets, *extra):
            log_path = out + ".log"
            with open(log_path, "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "zipvoice_torch.bin.export_model",
                     "--model-dir", model_dir, "--out-dir", out, "--bf16",
                     "--buckets", bucket_arg(buckets), *extra],
                    cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                    stdout=log, stderr=subprocess.STDOUT))
            return procs[-1], log_path

        # the CLI exports run beside the in-process work below
        eng_base = os.path.join(tmp, "eng_base")
        base_export = export_cli(base, eng_base,
                                 [ENGINE_BASE_BUCKET, ENGINE_B8_BUCKET],
                                 "--num-step", "16", "--guidance-scale",
                                 "1.0", "--t-shift", "0.5")
        eng_serve = os.path.join(tmp, "eng_serve")
        serve_export = export_cli(
            distill, eng_serve, ENGINE_SERVE_BUCKETS, "--model-name",
            "zipvoice_distill", "--num-step", str(SERVE_NUM_STEP),
            "--guidance-scale", str(SERVE_GUIDANCE))

        model, _ = load_model_dir(base, dtype=torch.bfloat16)

        # (b) the kernel configuration
        set_kernel_config(model, True)
        eng_config = os.path.join(tmp, "eng_config")
        manifest = export_sample_program(model, eng_config,
                                         [ENGINE_CONFIG_BUCKET])
        _, engines = load_engine_dir(eng_config, model)
        engine = engines[ENGINE_CONFIG_BUCKET]
        config_launches, _ = replay_check(
            card, "kernel-configuration engine", model, engine,
            engine_inputs(model, *ENGINE_CONFIG_BUCKET, seed), 16)
        engine_stats(card, "kernel-configuration", manifest,
                     ENGINE_CONFIG_BUCKET, engine)
        set_kernel_config(model, False)
        del engines, engine
        torch.cuda.empty_cache()

        # the base export in f32, TF32 off, against eager sampling
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        model32, _ = load_model_dir(base, dtype=torch.float32)
        manifest = export_sample_program(model32, os.path.join(tmp, "f32"),
                                         [ENGINE_BASE_BUCKET])
        _, engines = load_engine_dir(os.path.join(tmp, "f32"), model32)
        x = engine_inputs(model32, *ENGINE_BASE_BUCKET, seed)
        with torch.inference_mode():
            got, pm = engines[ENGINE_BASE_BUCKET](*x)
            want, _ = model32.sample(*x, num_step=16, guidance_scale=1.0,
                                     t_shift=0.5)
            # in mel units: the pipeline scales the features by 1/0.1
            d = ((got - want).abs()[~pm].max() / 0.1).item()
        engine_stats(card, "f32", manifest, ENGINE_BASE_BUCKET,
                     engines[ENGINE_BASE_BUCKET])
        print(f"f32 engine (TF32 off) vs eager sample: max|d| {d:.3e} mel "
              f"(tol {PATH_ATOL}) [{card}]", flush=True)
        if not d <= PATH_ATOL:
            raise AssertionError(f"f32 engine vs eager: {d}")
        del engines, model32, got, want
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
        torch.cuda.empty_cache()

        # (a) the base through the CLIs: export_model (above), then
        # infer_exported in process, every count at 0 just before
        manifest = wait_export(card, "base", *base_export, eng_base)
        out_wav = os.path.join(tmp, "out.wav")
        messages = []

        class Keep(logging.Handler):
            def emit(self, record):
                messages.append(record.getMessage())

        keep = Keep()
        root = logging.getLogger()
        level = root.level
        root.addHandler(keep)
        root.setLevel(logging.INFO)
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        try:
            code = infer_exported.main([
                "--engine-dir", eng_base, "--model-dir", base,
                "--vocoder-path", os.path.join(base, "pytorch_model.bin"),
                "--prompt-wav", prompt, "--prompt-text", CLI_PROMPT_TEXT,
                "--text", CLI_TEXT, "--res-wav-path", out_wav])
        finally:
            root.removeHandler(keep)
            root.setLevel(level)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
        cli_launches = launch_counts()
        wav = load_wav(out_wav, 24000)
        check_wav("infer_exported", wav, wav.shape[-1] // 256)
        used = [m for m in messages if "(bucket B=" in m]
        print(f"infer_exported: exit {code} in {cli_s:.1f} s (load of both "
              f"buckets, capture, replay, vocoder); {used}; "
              f"{wav.shape[-1] / 24000:.3f} s of wav; launches "
              f"{ {k: v for k, v in cli_launches.items() if v} } (the "
              f"uncaptured run and the capture, a replay counts none) "
              f"[{card}]", flush=True)
        if code != 0 or "B=1 S=192 T=1280" not in " ".join(used):
            raise AssertionError(f"infer_exported: exit {code}, {used}")
        if wav.shape[-1] < 3 * 24000:
            raise AssertionError(f"infer_exported: {wav.shape[-1]} samples "
                                 f"for a 144-token text")
        if cli_launches["rel_pos_attention_weights"] <= 0:
            raise AssertionError("infer_exported launched no #1")

        # the base directory once in process: the B=1 engine against its
        # uncaptured programs, eager sampling and a direct capture, then
        # (d) phase 3's B=8 request replayed against eager, alternating
        vocos = load_vocos(os.path.join(base, "pytorch_model.bin"),
                           dtype=torch.bfloat16)
        eager = InferencePipeline(model, vocos, seed=seed)
        replay = InferencePipeline(model, vocos, seed=seed)
        replay.attach_engines(eng_base)
        engine = replay._engines[ENGINE_BASE_BUCKET]
        x = engine_inputs(model, *ENGINE_BASE_BUCKET, seed)
        base_launches, x1 = replay_check(card, "base engine", model, engine,
                                         x, 16)
        engine_stats(card, "base", manifest, ENGINE_BASE_BUCKET, engine)
        with torch.inference_mode():
            want, pm = model.sample(*x, num_step=16, guidance_scale=1.0,
                                    t_shift=0.5)
        d = (x1 - want).abs()[~pm].max().item()
        print(f"base engine vs eager sample, bf16: max|d| {d:.3e} "
              f"[{card}]", flush=True)
        direct_capture(card, model, engine, x, 16)
        del engine, want, x1

        req = micro_batches(model.feat_dim, seed)[2]
        replay.warm_engines()
        engine_stats(card, "B=8 request", manifest, ENGINE_B8_BUCKET,
                     replay._engines[ENGINE_B8_BUCKET])
        run_request(eager, req, 16)  # the eager bucket's first touch
        hits = replay.engine_hits
        walls = {"eager": [], "replay": []}
        outs = {}
        for i in range(ENGINE_WALL_REPEATS):
            for which in (("eager", "replay") if i % 2 else
                          ("replay", "eager")):
                pipe = eager if which == "eager" else replay
                pipe.rng = np.random.RandomState(seed)
                torch.cuda.synchronize()
                t = time.perf_counter()
                outs[which] = run_request(pipe, req, 16)
                torch.cuda.synchronize()
                walls[which].append(time.perf_counter() - t)
        if replay.engine_hits - hits != ENGINE_WALL_REPEATS:
            raise AssertionError(f"B=8 request: {replay.engine_hits - hits} "
                                 f"engine hits in {ENGINE_WALL_REPEATS}")
        d = max(float(np.abs(a[:n] - b[:n]).max()) for a, b, n in zip(
            outs["eager"][0], outs["replay"][0], outs["eager"][1]))
        check_outputs(*outs["replay"])
        we, wr = (float(np.median(walls[k])) for k in ("eager", "replay"))
        print(f"B=8 request {ENGINE_B8_BUCKET}, 16 steps + vocoder, bf16, "
              f"{ENGINE_WALL_REPEATS} each alternating: replayed median "
              f"{wr:.4f} s (" + ", ".join(f"{x:.4f}" for x in walls["replay"])
              + f"), eager median {we:.4f} s (" + ", ".join(
                  f"{x:.4f}" for x in walls["eager"]) + f"): {we / wr:.2f}x; "
              f"features max|d| replay vs eager {d:.3e} mel [{card}]",
              flush=True)
        del eager, replay, model, vocos
        torch.cuda.empty_cache()

        # (c) the server's --engine-dir under phase 13's client
        wait_export(card, "ZipVoice-Distill", *serve_export, eng_serve)
        port = free_port()
        url = f"http://127.0.0.1:{port}"
        t = time.perf_counter()
        with open(os.path.join(tmp, "server.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "zipvoice_torch.serving.server",
                 "--model-dir", distill, "--vocoder-path",
                 os.path.join(distill, "pytorch_model.bin"), "--port",
                 str(port), "--engine-dir", eng_serve, "--warmup"],
                cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                stdout=log, stderr=subprocess.STDOUT))
        deadline = time.perf_counter() + 600
        while True:
            if procs[-1].poll() is not None:
                raise AssertionError(
                    f"server exited {procs[-1].returncode}:\n"
                    + open(os.path.join(tmp, "server.log")).read()[-4000:])
            try:
                code, _, body = http(url, "/health")
                if code == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() > deadline:
                raise AssertionError("server did not come up in 600 s")
            time.sleep(0.5)
        health = json.loads(body)
        print(f"server --engine-dir --warmup: /health {health} "
              f"{time.perf_counter() - t:.1f} s after the start (load, "
              f"{len(ENGINE_SERVE_BUCKETS)} engines loaded, warmed and "
              f"captured) [{card}]", flush=True)
        texts = os.path.join(tmp, "texts.txt")
        with open(texts, "w", encoding="utf-8") as f:
            f.write("\n".join(SERVE_TEXTS) + "\n")
        sweep = []
        for conc in (1, 8):
            r = subprocess.run(
                [sys.executable, "-m", "zipvoice_torch.serving.client",
                 "--url", url, "--prompt-wav", prompt, "--prompt-text",
                 CLI_PROMPT_TEXT, "--text-file", texts, "--num-speakers",
                 "4", "--concurrency", str(conc), "--num-requests", "16"],
                cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"client failed:\n{r.stderr[-4000:]}")
            sweep += [line.split("INFO:root:", 1)[-1]
                      for line in r.stderr.splitlines()
                      if "concurrency" in line or "server phases" in line]
            before, health = health, json.loads(http(url, "/health")[2])
            hits = health["engine_hits"] - before["engine_hits"]
            misses = health["engine_misses"] - before["engine_misses"]
            print(f"c={conc} (4 first touches + 16 requests): {hits} engine "
                  f"hits, {misses} misses [{card}]", flush=True)
            if conc == 1 and (misses or hits < 20):
                raise AssertionError(f"c=1: {hits} hits, {misses} misses")
        print("client against the engines, beside phase 13's eager server "
              f"(the same traffic, {SERVE_NUM_STEP} steps, bf16):",
              flush=True)
        for line in sweep:
            print(f"  engines: {line} [{card}]", flush=True)
        for line in eager_sweep:
            print(f"  eager:   {line} [{card}]", flush=True)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        shutil.rmtree(tmp)
    print(f"engines phase: {time.perf_counter() - start:.1f} s wall "
          f"[{card}]", flush=True)
    return dict(cli=cli_launches, base=base_launches, config=config_launches)


# phase 17: the gRPC pair, tensor parallelism and evaluation on the card.
# (a) ZipVoice-Distill served as in phase 13 (4 steps, guidance 3.0,
# max_batch 8) behind the gRPC handler: the phase-11 prompt (3 s) and its
# 2.28 s prefix registered as two speakers, phase 13's text 0 sent to the
# first (the 1280-frame bucket) and text 2 to the second (the 1024 one), a
# stream of text 1 to the first.
GRPC_SPEAKERS = (("spk0", 0), ("spk2", 2))  # (name, prompt_prefixes index)
GRPC_REQUESTS = (("spk0", 0), ("spk2", 2))  # (speaker, SERVE_TEXTS index)
GRPC_CLIENT_ARGS = ("--concurrency", "1,4", "--n", "8", "--stream")
# (b) the base's fm_decoder, f32, heads split 2 + 2 over two gloo processes
# on the card, against one process: the ROADMAP's f32 backbone tolerance
TP_B, TP_T = 8, 1280
TP_ATOL = 2e-4
TP_LAUNCHES = 12
# (c) UTMOS on the card against the CPU, relative
UTMOS_RTOL = 1e-4
ECAPA_SHAPE = (2, 1024, 200)  # WavLM-large features: (B, 1024, frames)

# a subprocess: process RANK of two on the card over gloo, its slice of the
# base (shard_model) and one forward_fm_decoder; saves its output, #1's
# launches and its parameter bytes
TP_SCRIPT = """
import sys
import torch
sys.path.insert(0, sys.argv[1])
import chip_smoke
from zipvoice_torch.parallel import mesh
from zipvoice_torch.parallel.sharding_rules import shard_model
rank, port, seed, out = (int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
                         sys.argv[5])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
mesh.init_distributed(f"127.0.0.1:{port}", 2, rank, "cuda", backend="gloo")
model = chip_smoke.tp_model(seed)
counts = shard_model(model)
held = sum(p.numel() * p.element_size() for p in model.parameters())
y, launches = chip_smoke.tp_forward(model, seed)
torch.save({"out": y, "launches": launches, "held": held,
            "reducing": mesh.reducing(), **counts}, out)
mesh.destroy()
"""


def tp_model(seed):
    """The ZipVoice base at its published widths, f32, on the card."""
    import torch

    from zipvoice_torch.infer.workload import build_base

    return build_base(seed, torch.float32)[0]


def tp_forward(model, seed):
    """(forward_fm_decoder on seeded inputs at (TP_B, TP_T), rows padded
    to lengths 1280 down to 1110, on the host; #1's launches in it)."""
    import torch

    rng = np.random.RandomState(seed + 17)
    F = model.feat_dim
    x = {k: torch.from_numpy(rng.randn(TP_B, TP_T, F).astype(np.float32))
         for k in ("xt", "text_condition", "speech_condition")}
    lens = torch.tensor([TP_T - 170 * i // (TP_B - 1) for i in range(TP_B)])
    x["padding_mask"] = torch.arange(TP_T)[None, :] >= lens[:, None]
    x["t"] = torch.from_numpy(rng.uniform(0, 1, TP_B).astype(np.float32))
    x = {k: v.cuda() for k, v in x.items()}
    torch.cuda.synchronize()
    reset_launches()
    with torch.inference_mode():
        y = model.forward_fm_decoder(**x)
    torch.cuda.synchronize()
    return y.cpu(), launch_counts()["rel_pos_attention_weights"]


class StubContext:
    """A gRPC servicer context in process: keeps the initial metadata and
    an abort's code and raises on abort, as grpc's context does."""

    def __init__(self):
        self.metadata, self.code = None, None

    def send_initial_metadata(self, metadata):
        self.metadata = metadata

    def abort(self, code, details):
        self.code = code
        raise RuntimeError(f"aborted ({code}): {details}")


def status_number(code):
    """A gRPC status as its number (a ``grpc.StatusCode`` or the number)."""
    return getattr(code, "value", (code,))[0]


def phase_grpc(card, seed, tmp):
    """(a): the gRPC handler in process (and over the wire where grpc
    imports).  Returns #1's launches in the in-process requests and the
    first Synthesize's wav (24 kHz)."""
    import base64
    import io
    import subprocess
    import wave

    import torch

    from zipvoice_torch.bin.make_model_dir import BASE_CONFIG, make_model_dir
    from zipvoice_torch.frontend.audio import save_wav
    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.infer.workload import speech_like_wav
    from zipvoice_torch.serving import client, grpc_server, server
    from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos

    name = "zipvoice_distill"
    make_model_dir(tmp, name, config=BASE_CONFIG, seed=seed, vocos_config={})
    model, tok = load_model_dir(tmp, name, dtype=torch.bfloat16)
    vocos = load_vocos(os.path.join(tmp, "pytorch_model.bin"),
                       dtype=torch.bfloat16)
    pipe = InferencePipeline(model, vocos, seed=seed, tokenizer=tok)
    engine = server.TTSEngine(pipe, max_batch=8, num_step=SERVE_NUM_STEP,
                              guidance_scale=SERVE_GUIDANCE)
    handler = grpc_server._TTSHandler(engine, SERVE_NUM_STEP, SERVE_GUIDANCE)
    prompt = os.path.join(tmp, "prompt.wav")
    save_wav(prompt, speech_like_wav(seed, seconds=3.0), 24000)
    prefixes = client.prompt_prefixes(prompt, 4)
    try:
        for spk, i in GRPC_SPEAKERS:
            reply = handler.register(json.dumps({
                "name": spk, "prompt_text": CLI_PROMPT_TEXT,
                "wav_b64": base64.b64encode(prefixes[i]).decode()}).encode(),
                StubContext())
            if json.loads(reply) != {"ok": True}:
                raise AssertionError(f"RegisterSpeaker {spk}: {reply!r}")
        dispatched = record_dispatches(model)
        torch.cuda.synchronize()
        reset_launches()
        t = time.perf_counter()
        wavs = []
        for spk, i in GRPC_REQUESTS:
            body = handler.synthesize(json.dumps({
                "speaker": spk, "text": SERVE_TEXTS[i]}).encode(),
                StubContext())
            seconds = check_served_wav(f"Synthesize {spk}", body)
            wavs.append(body)
            print(f"gRPC Synthesize in process ({spk}, text {i}): "
                  f"{seconds:.3f} s of audio [{card}]", flush=True)
        ctx = StubContext()
        chunks = list(handler.synthesize_stream(json.dumps({
            "speaker": "spk0", "text": SERVE_TEXTS[1]}).encode(), ctx))
        pcm = np.concatenate([np.frombuffer(c, "<i2") for c in chunks])
        seconds = check_served_pcm("SynthesizeStream", pcm)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launched = launch_counts()
        del model.sample
        if seconds <= 0.1 or dict(ctx.metadata or ()) != {
                "sample-rate": "24000"}:
            raise AssertionError(f"stream: {seconds} s, {ctx.metadata}")
        want = dict.fromkeys(launched, 0)
        for _, S, T in dispatched:
            for k, n in expected_launches(model, S, T,
                                          SERVE_NUM_STEP).items():
                want[k] += n
        print(f"gRPC in process: 2 Synthesize + 1 SynthesizeStream ("
              f"{len(chunks)} chunks, {seconds:.3f} s) in {wall:.2f} s; "
              f"buckets (B, S, T) {dispatched}; launches "
              f"{ {k: v for k, v in launched.items() if v} } (expected "
              f"{ {k: v for k, v in want.items() if v} }) [{card}]",
              flush=True)
        if launched != want or launched["rel_pos_attention_weights"] <= 0:
            raise AssertionError(f"gRPC launches {launched}, want {want}")
        if not {T for _, _, T in dispatched} >= {1024, 1280}:
            raise AssertionError(f"buckets {dispatched}: not 1024 and 1280")
        for method in (handler.synthesize, handler.synthesize_stream):
            ctx = StubContext()
            try:
                list(method(json.dumps({"speaker": "nobody",
                                        "text": "x"}).encode(), ctx))
            except RuntimeError:
                pass
            if status_number(ctx.code) != grpc_server.INVALID_ARGUMENT:
                raise AssertionError(f"{method.__name__}: unknown speaker "
                                     f"gave {ctx.code}")
        print("gRPC unknown speaker: Synthesize and SynthesizeStream abort "
              f"with status {grpc_server.INVALID_ARGUMENT} [{card}]",
              flush=True)

        try:
            import grpc
        except ImportError:
            grpc = None
            print("gRPC over the wire: not run (no grpcio on this machine); "
                  "the handler ran in process above", flush=True)
        if grpc is not None:
            srv, port = grpc_server.make_server(engine, 0, SERVE_NUM_STEP,
                                                SERVE_GUIDANCE)
            srv.start()
            try:
                with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
                    rpc = {m: ch.unary_unary(f"/{grpc_server.SERVICE}/{m}")
                           for m in ("RegisterSpeaker", "Synthesize")}
                    rpc["RegisterSpeaker"](json.dumps({
                        "name": "wire", "prompt_text": CLI_PROMPT_TEXT,
                        "wav_b64": base64.b64encode(prefixes[0]).decode()
                    }).encode())
                    check_served_wav("Synthesize over the wire", rpc[
                        "Synthesize"](json.dumps({
                            "speaker": "wire",
                            "text": SERVE_TEXTS[0]}).encode()))
                    stream = ch.unary_stream(
                        f"/{grpc_server.SERVICE}/SynthesizeStream")
                    check_served_pcm("SynthesizeStream over the wire",
                                     np.concatenate([
                                         np.frombuffer(c, "<i2")
                                         for c in stream(json.dumps({
                                             "speaker": "wire",
                                             "text": SERVE_TEXTS[1]
                                         }).encode())]))
                t = time.perf_counter()
                r = subprocess.run(
                    [sys.executable, "-m", "zipvoice_torch.serving."
                     "client_grpc", "--target", f"127.0.0.1:{port}",
                     "--prompt-wav", prompt, "--prompt-text",
                     CLI_PROMPT_TEXT, *GRPC_CLIENT_ARGS], cwd=REPO,
                    env=dict(os.environ, PYTHONPATH=REPO),
                    capture_output=True, text=True, timeout=600)
                if r.returncode != 0:
                    raise AssertionError(f"client_grpc: {r.stderr[-4000:]}")
                print(f"gRPC over the wire: Register, Synthesize and "
                      f"SynthesizeStream, then client_grpc "
                      f"{' '.join(GRPC_CLIENT_ARGS)} in "
                      f"{time.perf_counter() - t:.1f} s:", flush=True)
                for line in r.stdout.strip().splitlines():
                    print(f"  {line} [{card}]", flush=True)
            finally:
                srv.stop(0)
    finally:
        engine.close()
    with wave.open(io.BytesIO(wavs[0])) as f:
        wav = np.frombuffer(f.readframes(f.getnframes()), "<i2")
    return launched["rel_pos_attention_weights"], wav.astype(
        np.float32) / 32768.0


def tp_kernel_check(card, seed):
    """#1 against its plain version at the head counts a rank of (b) gives
    it, f32: 2 heads on the rank that holds head 0, 3 (head 0 and its own
    two) on the other, at the stacks' T of 1280 and 640 (320 is below the
    gate)."""
    import torch

    from zipvoice_torch.kernels.rel_pos_attention import (
        rel_pos_attention_weights,
        rel_pos_attention_weights_ref,
    )

    worst = 0.0
    for h in (2, 3):
        for T in (TP_T, TP_T // 2):
            args = attention_inputs(TP_B, h, T, 32, 4, seed + 17 * h + T,
                                    torch.float32)
            got = rel_pos_attention_weights(*args)
            torch.cuda.synchronize()
            err = float((got - rel_pos_attention_weights_ref(*args)
                         ).abs().max())
            print(f"kernel rel_pos_attention_weights B={TP_B} h={h} T={T} "
                  f"f32 (a tensor-parallel rank's heads): max|d| vs plain "
                  f"{err:.3e} (tol {F32_ATOL:.0e}) [{card}]", flush=True)
            if not err <= F32_ATOL:
                raise AssertionError(f"f32 kernel disagrees at h={h}, "
                                     f"T={T}: {err}")
            worst = max(worst, err)
            del args, got
    torch.cuda.empty_cache()
    return worst


def phase_tensor_parallel(card, seed, tmp):
    """(b): two processes on the card over gloo, each with its half of the
    heads and hidden units, against one process's replicated forward.
    Returns #1's launches on each rank."""
    import subprocess

    import torch

    port = free_port()
    outs = [os.path.join(tmp, f"tp{r}.pt") for r in range(2)]
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", TP_SCRIPT, REPO, str(r), str(port),
         str(seed), outs[r]], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            model = tp_model(seed)
            whole = sum(p.numel() * p.element_size()
                        for p in model.parameters())
            want, solo_launches = tp_forward(model, seed)
            del model
            tp_kernel_check(card, seed)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        for p in procs:
            o, e = p.communicate(timeout=MULTI_TIMEOUT)
            if p.returncode != 0:
                raise AssertionError(f"TP rank: exit {p.returncode}\n"
                                     f"{o[-2000:]}\n{e[-6000:]}")
    finally:
        for p in procs:
            p.kill()
    ranks = [torch.load(o) for o in outs]
    d = max(float((r["out"] - want).abs().max()) for r in ranks)
    print(f"tensor parallel: forward_fm_decoder at (B, T) = ({TP_B}, "
          f"{TP_T}), f32, heads 2 + 2 on two gloo processes, against one "
          f"process: max |d| {d:.3e} (limit {TP_ATOL}); #1 launches "
          f"{[r['launches'] for r in ranks]} a rank, {solo_launches} in one "
          f"process; modules split {[r['split'] for r in ranks]}, kept "
          f"whole {[r['whole'] for r in ranks]}; parameter bytes a rank "
          f"{[r['held'] for r in ranks]} of {whole}; "
          f"{time.perf_counter() - t:.1f} s [{card}]", flush=True)
    if d > TP_ATOL or not all(r["launches"] == TP_LAUNCHES for r in ranks):
        raise AssertionError("tensor parallel forward does not match")
    if not all(r["whole"] == 0 and r["held"] < whole for r in ranks):
        raise AssertionError("a rank holds the whole model")
    if any(r["reducing"] for r in ranks):
        raise AssertionError("batch statistics all-reduced under TP")
    return ranks[0]["launches"]


def phase_eval(card, seed, wav24):
    """(c): UTMOS22Strong (seeded random weights) on the card against the
    CPU over ``wav24`` resampled to 16 kHz, and the ECAPA head at WavLM-large
    widths over seeded features."""
    import torch

    from zipvoice_torch.eval.speaker_model import EcapaWavLM
    from zipvoice_torch.eval.utmos_model import UTMOS22Strong
    from zipvoice_torch.frontend.audio import resample

    wav = torch.from_numpy(resample(wav24, 24000, 16000))[None]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        utmos = UTMOS22Strong().eval()
        ecapa = EcapaWavLM(feat_dim=ECAPA_SHAPE[1],
                           num_hidden_states=25).eval()
    feats = torch.from_numpy(np.random.RandomState(seed).randn(
        *ECAPA_SHAPE).astype(np.float32))
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            t = time.perf_counter()
            cpu = float(utmos(wav, 16000))
            cpu_s = time.perf_counter() - t
            utmos.cuda()
            float(utmos(wav.cuda(), 16000))  # first call: cuDNN's plans
            torch.cuda.synchronize()
            t = time.perf_counter()
            card_score = float(utmos(wav.cuda(), 16000))
            card_s = time.perf_counter() - t
            emb_cpu = ecapa.head(feats)
            emb = ecapa.cuda().head(feats.cuda()).cpu()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    rel = abs(card_score - cpu) / abs(cpu)
    print(f"UTMOS22Strong (random weights) over {wav.shape[1] / 16000:.2f} s "
          f"at 16 kHz: card {card_score:.6f} in {card_s * 1e3:.1f} ms, CPU "
          f"{cpu:.6f} in {cpu_s * 1e3:.1f} ms, relative |d| {rel:.3e} "
          f"(limit {UTMOS_RTOL}) [{card}]", flush=True)
    print(f"ECAPA head at WavLM-large widths over {tuple(ECAPA_SHAPE)}: "
          f"embedding {tuple(emb.shape)}, max |d| against the CPU "
          f"{float((emb - emb_cpu).abs().max()):.3e}; the WavLM, Whisper "
          f"and ASR models need transformers and weights, which this "
          f"machine lacks: their drivers run in the CPU tests [{card}]",
          flush=True)
    if not (np.isfinite(card_score) and rel <= UTMOS_RTOL):
        raise AssertionError(f"UTMOS card {card_score} vs CPU {cpu}")
    if emb.shape != (ECAPA_SHAPE[0], 192) or not torch.isfinite(emb).all():
        raise AssertionError(f"ECAPA embedding {emb.shape}")


def phase_grpc_tp_eval(card, seed):
    """Phase 17: (a) gRPC, (b) tensor parallel, (c) evaluation.  Returns
    #1's launches in (a)'s in-process requests and on each rank in (b)."""
    import shutil
    import tempfile

    import torch

    start = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="zipvoice_p17_")
    try:
        grpc_launches, wav = phase_grpc(card, seed, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        tp_launches = phase_tensor_parallel(card, seed, tmp)
        phase_eval(card, seed, wav)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"gRPC, tensor-parallel and evaluation phase: "
          f"{time.perf_counter() - start:.1f} s wall [{card}]", flush=True)
    return {"grpc": grpc_launches, "tp": tp_launches}


def print_tensor_core_use(names):
    """Each built kernel's tensor-core instructions (HMMA, and MOVM, the
    warp's matrix transpose) in its SASS, from ``cuobjdump``."""
    import subprocess

    from zipvoice_torch.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    for name in names:
        sass = subprocess.run([tool, "-sass", _build.library_path(name)],
                              capture_output=True, text=True, check=True)
        counts = {}
        fn = None
        for line in sass.stdout.splitlines():
            found = re.search(
                r"Function : \S*?_cu_[0-9a-f]{8}(\d+)(\w+)", line)
            if found:
                n, rest = int(found.group(1)), found.group(2)
                fn = rest[:n] + "<" + rest[n:].split("Ev", 1)[0] + ">"
                counts[fn] = [0, 0]
            elif fn is not None:
                counts[fn][0] += " HMMA." in line
                counts[fn][1] += " MOVM." in line
        print(f"  {name} SASS: " + "; ".join(
            f"{fn} HMMA {h}" + (f" MOVM {m}" if m else "")
            for fn, (h, m) in counts.items()), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-step", type=int, default=16)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, "zipvoice_torch")):
        print("chip_smoke: zipvoice_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from zipvoice_torch.infer.workload import card_identity
    from zipvoice_torch.kernels import _build

    start = time.perf_counter()
    card = card_identity()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    names = _build.kernel_sources()
    reports = _build.build(names)
    print(f"build: {len(names)} kernel source(s) for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, report in reports.items():
        entry = ""
        for line in report.splitlines():
            found = re.search(
                r"entry function '_Z\w*?_cu_[0-9a-f]{8}(\d+)(\w+)'", line)
            if found:
                # the kernel's name and its template arguments, mangled
                n, rest = int(found.group(1)), found.group(2)
                entry = rest[:n] + "<" + rest[n:].split("Ev", 1)[0] + ">"
            elif "ptxas info" in line and "Used" in line:
                print(f"  {name}: {entry}: {line.split(':', 1)[1].strip()}")
            elif "spill" in line:
                print(f"  {name}: {entry}: {line.strip()}")
    print_tensor_core_use(names)

    measured = phase_kernels(card, args.seed)
    vocos, req, bf16_out, launches = phase_main_path(card, args.seed,
                                                     args.num_step)
    f32_plain = phase_f32_check(card, args.seed, args.num_step, vocos, req,
                                bf16_out)
    measured.update(phase_train_kernels(card, args.seed))
    train_launches, batch = phase_train(card, args.seed)
    f32_model, f32_pair_run = phase_train_f32_check(card, args.seed, batch)
    measured.update(phase_config_kernels(card, args.seed))
    config_launches = phase_config_request(card, args.seed, args.num_step,
                                           vocos, req, bf16_out, f32_plain)
    del vocos, req, bf16_out, f32_plain
    config_train = phase_config_train(card, args.seed, batch, f32_model,
                                      f32_pair_run)
    del f32_model, f32_pair_run
    cli_launches = phase_cli(card, args.seed)
    dialog_launches = phase_dialog(card, args.seed)
    serving_launches, eager_sweep = phase_serving(card, args.seed)
    train_cli = phase_train_cli(card, args.seed)
    engine_launches = phase_engines(card, args.seed, eager_sweep)
    multi_launches = phase_multiprocess(card, args.seed,
                                        train_cli["step_wall"])
    p17_launches = phase_grpc_tp_eval(card, args.seed)

    # each kernel's launches in the run of the path it serves: the default
    # request (phase 3), the kernel-configuration request (phase 9), the
    # default training run (phase 6) and the kernel-configuration training
    # run (phase 10)
    launches = {
        "rel_pos_attention_weights": launches,
        "rel_pos_attention_weights_nonlin":
            config_launches["rel_pos_attention_weights_nonlin"],
        "attention_apply": config_launches["attention_apply"],
        "rel_pos_attention_weights_train":
            train_launches["rel_pos_attention_weights_train"],
        "rel_pos_attention_weights_bwd":
            train_launches["rel_pos_attention_weights_bwd"],
        "depthwise_conv1d": config_launches["depthwise_conv1d"],
        "depthwise_conv1d_bwd": config_train["depthwise_conv1d_bwd"],
    }
    # (source, TPU kernel, the device kernels of the bf16 build the path runs)
    sources = {
        "rel_pos_attention_weights": (
            "zipvoice_torch/csrc/rel_pos_attention.cu",
            "zipvoice_tpu/ops/pallas_attention.py:103",
            ["rel_pos_mma_kernel<32, false>"]),
        "rel_pos_attention_weights_nonlin": (
            "zipvoice_torch/csrc/rel_pos_attention_nonlin.cu",
            "zipvoice_tpu/ops/pallas_attention.py:240",
            ["nonlin_mma_kernel<32, 384>"]),
        "attention_apply": (
            "zipvoice_torch/csrc/attention_apply.cu",
            "zipvoice_tpu/ops/pallas_attention.py:363",
            ["attn_apply_mma_kernel"]),
        "rel_pos_attention_weights_train": (
            "zipvoice_torch/csrc/rel_pos_attention.cu",
            "zipvoice_tpu/ops/pallas_attention.py:423",
            ["rel_pos_mma_kernel<32, true>"]),
        "rel_pos_attention_weights_bwd": (
            "zipvoice_torch/csrc/rel_pos_attention_bwd.cu",
            "zipvoice_tpu/ops/pallas_attention.py:519",
            ["bwd_rows_mma_kernel<32>", "bwd_keys_mma_kernel<32>",
             "bwd_fold_mma_kernel"]),
        "depthwise_conv1d": (
            "zipvoice_torch/csrc/depthwise_conv.cu",
            "zipvoice_tpu/ops/pallas_conv.py:26",
            ["dwconv_kernel<bf16, K>"]),
        "depthwise_conv1d_bwd": (
            "zipvoice_torch/csrc/depthwise_conv.cu",
            "zipvoice_tpu/ops/pallas_conv.py:41",
            ["dwconv_bwd_kernel<bf16, K>"]),
    }
    kernels = [dict(
        name=name, route="cuda", source=src, replaces=tpu,
        device_kernels=device, launches=launches[name],
        **{"library_ms": None, **measured[name]},
    ) for name, (src, tpu, device) in sources.items()]
    # #1's launches in phase 11's generate_sentence, the CLI path, and in
    # phase 12's two dialog requests
    kernels[0]["launches_cli_path"] = cli_launches
    kernels[0]["launches_dialog_path"] = dialog_launches["zipvoice_dialog"]
    kernels[0]["launches_dialog_stereo_path"] = dialog_launches[
        "zipvoice_dialog_stereo"]
    # and in phase 13's served traffic (the routes and the client's sweep)
    kernels[0]["launches_serving_path"] = serving_launches
    # and #1, #4 and #5 in phase 14's trainer CLI runs (the resumed run
    # included) and the two distillation stages
    for k in kernels:
        for path in ("train", "distill"):
            if train_cli[path][k["name"]]:
                k[f"launches_{path}_cli_path"] = train_cli[path][k["name"]]
    # and phase 15's engines, uncaptured: #1 in the base engine (and in
    # infer_exported, whose capture launches each call site once more),
    # #2, #3 and #6 in the kernel configuration's
    kernels[0]["launches_engine_path"] = engine_launches["base"][
        "rel_pos_attention_weights"]
    kernels[0]["launches_engine_cli_path"] = engine_launches["cli"][
        "rel_pos_attention_weights"]
    for k in kernels:
        if engine_launches["config"][k["name"]]:
            k["launches_engine_path"] = engine_launches["config"][k["name"]]
    # and #4 and #5 in phase 16's trainer run on a process group
    for k in kernels:
        if multi_launches[k["name"]]:
            k["launches_multiprocess_path"] = multi_launches[k["name"]]
    # and phase 17's gRPC requests in process and each tensor-parallel rank
    kernels[0]["launches_grpc_path"] = p17_launches["grpc"]
    kernels[0]["launches_tensor_parallel_rank"] = p17_launches["tp"]
    print(f"chip_smoke: phases 1-17 in {time.perf_counter() - start:.1f} s",
          flush=True)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
