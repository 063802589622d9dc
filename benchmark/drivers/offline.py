"""Offline synthesis through ``InferencePipeline.generate_sentence``: one
caller, calls back to back, as ``bin/infer_zipvoice`` runs them for a long
text.  The window runs calls until ``--seconds`` have passed and ends with
the last call, so that it holds whole calls only."""

import gc
import os
import sys
import time

import numpy as np

from benchmark import traffic_gen as tg
from benchmark.data.speech import read_wav_bytes, wav_bytes
from benchmark.drivers.program import (build_pipeline, build_weights,
                                       record_sample_calls, sample_flops,
                                       time_kernel_builds)
from benchmark.harness import Profiled, host_clocks, seed_for
from benchmark.reference import frontend as fe
from benchmark.reference.check import Reference, rel_err
from benchmark.reference.model import fp8


def _shapes(traffic, pool, prompts, prompt_s):
    """Every (B, S, T) bucket the pool's passages take under their
    prompts, and every (rows, frames) their chunks are vocoded at: the
    pipeline's chunking, packing and bucketing, worked out on the host."""
    shapes, vocoded = set(), set()
    speed = traffic["speed"]
    for p in pool:
        secs, pfl = prompt_s[p["prompt"]]
        n_prompt = len(prompts[p["prompt"]]["phones"])
        token_s = secs / (n_prompt * speed)
        chunks = fe.chunk_tokens(p["phones"],
                                 max(4, int((25 - secs) / token_s)))
        batches, _ = fe.pack_batches(chunks, traffic["max_duration"], secs,
                                     token_s)
        generated = []
        for batch in batches:
            fl = fe.predicted_frames(
                [pfl] * len(batch), [n_prompt] * len(batch),
                [len(chunks[i]) for i in batch], [speed] * len(batch))
            generated += [int(n) - pfl for n in fl]
            shapes.add((
                fe.bucket_length(len(batch), fe.BATCH_BUCKETS),
                fe.bucket_length(max(n_prompt + len(chunks[i])
                                     for i in batch) + 1, fe.TOKEN_BUCKETS),
                fe.bucket_length(int(fl.max()), fe.FRAME_BUCKETS)))
        groups = {}
        for n in generated:
            T = fe.bucket_length(n, fe.FRAME_BUCKETS)
            groups[T] = groups.get(T, 0) + 1
        vocoded.update((rows, T) for T, rows in groups.items())
    return sorted(shapes), sorted(vocoded)


def run(ctx):
    torch, device, cell = ctx.torch, ctx.device, ctx.cell
    config, traffic = cell.config, cell.traffic
    inf = config["inference"]
    corpus = tg.Corpus()
    pool = tg.passages(corpus, traffic["passages"])
    prompts = tg.prompts(corpus, traffic["prompts"])
    paths = []
    for k, pr in enumerate(prompts):
        path = os.path.join(ctx.tmpdir, f"prompt{k}.wav")
        with open(path, "wb") as f:
            f.write(wav_bytes(pr["wav"], tg.SR))
        paths.append(path)
        with open(path, "rb") as f:
            pr["wav"] = read_wav_bytes(f.read())[0]
    # (seconds, frames) of each prepared prompt, for the shapes
    prompt_s = []
    for pr in prompts:
        feats, _, secs = fe.prepare_prompt(pr["wav"], inf["feat_scale"],
                                           inf["target_rms"])
        prompt_s.append((secs, feats.shape[0]))

    builds = time_kernel_builds()
    t_weights = time.monotonic()
    P, V = build_weights(config, ctx.seed, device)
    pipe = build_pipeline(config, P, V, device)
    t_warm = time.monotonic()
    records = []
    record_sample_calls(pipe, records)
    chunk_feats = []
    orig_sample = pipe._sample_batch

    def keep_features(*a, **kw):
        feats, lens = orig_sample(*a, **kw)
        chunk_feats.extend(feats[i, :n].copy() for i, n in enumerate(lens))
        return feats, lens

    pipe._sample_batch = keep_features
    # host seconds of each part of a call, summed over the call
    parts = {}

    def timed(name, fn):
        def wrapped(*a, **kw):
            t = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                parts[name] = parts.get(name, 0.0) + time.monotonic() - t
        return wrapped

    pipe._prompt = timed("prompt", pipe._prompt)
    pipe._sample_batch = timed("sample", pipe._sample_batch)
    pipe._vocode_chunks = timed("vocode", pipe._vocode_chunks)

    def call(i):
        passage, k, noise_seed = tg.offline_call(i, pool, ctx.seed)
        pipe.rng = np.random.RandomState(noise_seed)
        del records[:], chunk_feats[:]
        parts.clear()
        h0 = host_clocks()
        t0 = time.monotonic()
        wav, m = pipe.generate_sentence(
            prompts[k]["text"], paths[k], passage["text"],
            num_step=inf["num_step"], guidance_scale=inf["guidance_scale"],
            speed=traffic["speed"], t_shift=inf["t_shift"],
            target_rms=inf["target_rms"],
            max_duration=traffic["max_duration"])
        t1 = time.monotonic()
        h1 = host_clocks()
        return {"i": i, "k": k, "noise_seed": noise_seed, "t0": t0,
                "t1": t1, "wav": wav, "m": m, "parts": dict(parts),
                "host": {n: h1[n] - h0[n] for n in h0},
                "samples": list(records), "feats": list(chunk_feats),
                "passage": passage}

    # warm-up: one step at every bucket the pool takes, its vocoding
    # shapes, then one call
    shapes, vocoded = _shapes(traffic, pool, prompts, prompt_s)
    for B, S, T in shapes:
        pipe.warm_bucket(B, S, T, 1, inf["guidance_scale"], inf["t_shift"])
    for rows, T in vocoded:
        pipe._vocode_chunks([np.zeros((T, config["model"]["feat_dim"]),
                                      np.float32)] * rows)
    call(-1)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_setup = time.monotonic()
    setup_s = t_setup - ctx.t_start
    # set-up's parts; the warm-up holds the kernels' build where nvcc ran
    setup_parts = {"start_s": t_weights - ctx.t_start,
                   "weights_s": t_warm - t_weights,
                   "warm_s": t_setup - t_warm, **builds}

    prof = (Profiled(torch, os.path.join(ctx.tmpdir, "trace.json"))
            if ctx.trace else None)
    prof_at = None
    calls = []
    t0 = time.monotonic()
    i = 0
    while True:
        if (prof is not None and prof_at is None
                and time.monotonic() - t0 >= ctx.seconds
                - traffic["trace_slice_s"]):
            prof_at = prof.start()
        calls.append(call(i))
        i += 1
        # a traced window ends only once the profiler has seen a call
        if (calls[-1]["t1"] - t0 >= ctx.seconds
                and (prof is None or prof_at is not None)):
            break
    t1 = calls[-1]["t1"]
    trace = prof.stop() if prof is not None else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    for c in calls:
        p, h, wall = c["parts"], c["host"], c["t1"] - c["t0"]
        enqueue = sum(r["enqueue_s"] for r in c["samples"])
        print(f"call {c['i']}: {c['passage']['sentences']} sentences, "
              f"batches (rows, B, T) "
              f"{[(r['B_real'], r['B'], r['T']) for r in c['samples']]}, "
              f"{wall:.3f} s, {c['wav'].shape[-1] / tg.SR:.1f} audio-s; "
              f"host ms: front end {c['m']['t_frontend'] * 1e3:.1f} "
              f"(prompt {p.get('prompt', 0) * 1e3:.1f}), "
              f"enqueue {enqueue * 1e3:.1f}, sample {p['sample'] * 1e3:.1f}, "
              f"vocode {p['vocode'] * 1e3:.1f}, rest "
              f"{(wall - c['m']['t_frontend'] - c['m']['t']) * 1e3:.1f}; "
              f"thread cpu {h['cpu_s'] * 1e3:.1f}, run queue "
              f"{h['runq_s'] * 1e3:.1f}, stolen {h['steal_s'] * 1e3:.0f}",
              file=sys.stderr)
    # metrics that need no profiler come from the calls before it started
    plain = [c for c in calls if prof_at is None or c["t1"] <= prof_at]
    t_plain = (prof_at if prof_at is not None else t1) - t0
    print(f"set-up {setup_s:.3f} s: {setup_parts}", file=sys.stderr)
    rec = {
        "setup_s": setup_s,
        "setup_parts": setup_parts,
        "window_s": t1 - t0,
        "audio_s": sum(c["wav"].shape[-1] / tg.SR for c in calls),
        "plain_window_s": t_plain,
        "flops": sum(sample_flops(r, config)
                     for c in plain for r in c["samples"]),
        "sample_calls": [r for c in plain for r in c["samples"]],
        "offline_calls": [{"t_frontend": c["m"]["t_frontend"],
                           "t": c["m"]["t"],
                           "t_vocoder": c["m"]["t_vocoder"]} for c in plain],
        "trace": trace,
        "attn": {"h": config["model"]["fm_decoder_num_heads"],
                 "qd": config["model"]["query_head_dim"],
                 "pd": config["model"]["pos_head_dim"]},
    }

    # the reference, once the program is gone
    keep = _checked(calls, traffic["check"]["calls"], ctx.seed)
    del pipe, calls, call, keep_features, orig_sample
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    reference = Reference(config, P, V, device)
    # the control "fp8": the reference computed in fp8, in the program's
    # place
    lower = (Reference(config, P, V, device, rounding=fp8)
             if ctx.control == "fp8" else None)
    feat_err, wav_err = 0.0, 0.0
    readings = {"feat": [], "wav": []}
    for c in keep:
        pr = prompts[c["k"]]
        args = (pr["wav"], pr["phones"], c["passage"]["phones"],
                corpus.token2id, c["noise_seed"], traffic["max_duration"],
                traffic["speed"])
        want_feats, want_wav = reference.offline_call(*args)
        if lower is not None:
            c["feats"], c["wav"] = lower.offline_call(*args)
        if len(want_feats) != len(c["feats"]):
            feat_err = float("inf")
        for got, want in zip(c["feats"], want_feats):
            feat_err = max(feat_err, rel_err(got, want))
            readings["feat"].append(rel_err(got, want))
        wav_err = max(wav_err, rel_err(c["wav"], want_wav))
        readings["wav"].append(rel_err(c["wav"], want_wav))
    print(f"reference: {len(keep)} calls, "
          f"{sum(len(c['feats']) for c in keep)} rows, "
          f"{time.monotonic() - t_check:.1f} s", file=sys.stderr)
    limits = traffic["check"]["limits"]
    checks = [{"name": "feat_rel_err", "value": feat_err,
               "limit": limits["feat_rel_err"]},
              {"name": "wav_rel_err", "value": wav_err,
               "limit": limits["wav_rel_err"]},
              {"name": "calls_checked", "value": len(keep), "limit": 1}]
    correct = (feat_err <= limits["feat_rel_err"]
               and wav_err <= limits["wav_rel_err"] and len(keep) >= 1)
    return {"rec": rec, "checks": checks, "correct": correct,
            "attempted": i, "failed": 0,
            "memory_peak_bytes": peak, "trace": trace,
            "readings": readings}


def _checked(calls, n: int, seed: int):
    """The calls the reference recomputes: the one that made the most
    audio and ``n - 1`` more drawn from the seed."""
    longest = max(range(len(calls)), key=lambda j: calls[j]["wav"].shape[-1])
    rest = [j for j in range(len(calls)) if j != longest]
    rng = np.random.RandomState(seed_for(seed, "checked"))
    picked = [longest] + list(rng.choice(rest, size=min(n - 1, len(rest)),
                                         replace=False))
    return [calls[j] for j in picked]
