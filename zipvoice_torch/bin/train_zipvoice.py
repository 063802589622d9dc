"""Train ZipVoice (flow-matching TTS) on the card (counterpart of
``zipvoice_tpu/bin/train_zipvoice.py``).

One process on one CUDA device: f32 parameters with bf16 compute and no
loss scaling, ScaledAdam with Eden, the batch-count schedules, a running
f64 model average, checkpoint directories with rotation and a resumable
sampler state.  The attention kernels are on: every U-Net level whose
length reaches the gate takes the trainable kernel pair.

  python -m zipvoice_torch.bin.train_zipvoice \\
    --train-manifest data/manifests/custom_cuts_train.jsonl.gz \\
    --token-file data/tokens.txt --exp-dir exp/zipvoice \\
    --num-epochs 11 --max-duration 250

Resume with ``--start-epoch N+1`` (reads ``exp-dir/epoch-N``).  Without
CUDA the trainer fails unless given ``--platform cpu``.
"""

import argparse
import json
import logging
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch

# flags of the JAX trainer whose parts the port has not taken yet: each
# raises, naming the ROADMAP item that brings it
_WAITING = {
    "coordinator_address": "multi-process training (ROADMAP A5e)",
    "num_processes": "multi-process training (ROADMAP A5e)",
    "process_id": "multi-process training (ROADMAP A5e)",
    "inf_check": "utils/diagnostics.py (ROADMAP A6)",
    "print_diagnostics": "utils/diagnostics.py (ROADMAP A6)",
}


def get_parser():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    # model / tokenizer
    p.add_argument("--model-config", type=str, default=None,
                   help="model.json; defaults to the base ZipVoice config")
    p.add_argument("--token-file", type=str, required=True)
    p.add_argument("--tokenizer", type=str, default="emilia",
                   choices=["emilia", "espeak", "dialog", "libritts",
                            "simple"])
    p.add_argument("--lang", type=str, default="en-us")
    p.add_argument("--model-name", type=str, default="zipvoice",
                   choices=["zipvoice", "zipvoice_distill", "zipvoice_dialog",
                            "zipvoice_dialog_stereo"])
    # data
    p.add_argument("--train-manifest", type=str, action="append",
                   required=True, help="may repeat for muxed corpora")
    p.add_argument("--train-weight", type=float, action="append", default=None)
    p.add_argument("--dev-manifest", type=str, default=None)
    p.add_argument("--max-duration", type=float, default=250.0)
    p.add_argument("--num-buckets", type=int, default=30)
    p.add_argument("--on-the-fly-feats", action="store_true")
    p.add_argument("--streaming", action="store_true",
                   help="lazy manifest iteration with bounded shuffle/bucket "
                        "buffers (the reference streams lazy CutSets, "
                        "datamodule.py:177-195)")
    p.add_argument("--shuffle-buffer", type=int, default=10000,
                   help="streaming shuffle buffer, in cuts")
    p.add_argument("--num-workers", type=int, default=2,
                   help="concurrent batch-assembly threads (the reference "
                        "uses 8 DataLoader workers, datamodule.py:143-151)")
    p.add_argument("--per-host-data", type=str, default="auto",
                   choices=("auto", "on", "off"),
                   help="multi-process row sharding; 'on' waits for "
                        "multi-process training (ROADMAP A5e)")
    p.add_argument("--min-len", type=float, default=1.0)
    p.add_argument("--max-len", type=float, default=30.0)
    # optimization (reference train_zipvoice.py defaults)
    p.add_argument("--base-lr", type=float, default=0.02)
    p.add_argument("--scheduler", type=str, default="eden",
                   choices=["eden", "fixed"],
                   help="fixed = constant base-lr (the reference "
                        "FixedLRScheduler, used for finetuning)")
    p.add_argument("--lr-batches", type=float, default=7500)
    p.add_argument("--lr-epochs", type=float, default=10)
    p.add_argument("--lr-hours", type=float, default=0,
                   help="if >0, re-base the epoch axis to hours of audio")
    p.add_argument("--warmup-batches", type=float, default=500)
    p.add_argument("--clipping-scale", type=float, default=2.0)
    p.add_argument("--num-epochs", type=int, default=11)
    p.add_argument("--num-iters", type=int, default=0,
                   help="if >0, stop after this many optimizer steps "
                        "(reference --num-iters, used by finetune/distill)")
    p.add_argument("--condition-drop-ratio", type=float, default=0.2)
    p.add_argument("--dropout-rate", type=float, default=None,
                   help="static dropout override; default follows the "
                        "reference's scheduled 0.3->0.1/20k ramp")
    p.add_argument("--no-schedules", dest="schedules", action="store_false",
                   default=True,
                   help="disable the batch-count training schedules")
    p.add_argument("--ref-duration", type=float, default=50.0,
                   help="reference batch duration for the schedule clock "
                        "(reference train_zipvoice.py:195-202)")
    p.add_argument("--finetune", action="store_true",
                   help="shift the schedule clock past every ramp (+100k "
                        "batches, reference train_zipvoice.py:553-557)")
    p.add_argument("--feat-scale", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    # infra
    p.add_argument("--exp-dir", type=str, required=True)
    p.add_argument("--start-epoch", type=int, default=1,
                   help="> 1 resumes from exp-dir/epoch-(start-epoch - 1)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="reference-layout .pt/.safetensors, or a checkpoint "
                        "directory, to initialize from")
    p.add_argument("--init-from-base", type=str, default=None,
                   help="dialog finetune: base ZipVoice ckpt; the embedding "
                        "table is vocab-extended (reference "
                        "checkpoint.py:147-170)")
    p.add_argument("--init-from-dialog", type=str, default=None,
                   help="stereo finetune: mono Dialog ckpt; fm_decoder "
                        "projections are duplicated for two-stream "
                        "(reference checkpoint.py:173-229)")
    p.add_argument("--save-every-n", type=int, default=5000)
    p.add_argument("--keep-last-k", type=int, default=30)
    p.add_argument("--average-period", type=int, default=200)
    p.add_argument("--valid-interval", type=int, default=2000)
    p.add_argument("--log-interval", type=int, default=50)
    p.add_argument("--num-data-parallel", type=int, default=None,
                   help="more than 1 waits for multi-process training "
                        "(ROADMAP A5e)")
    p.add_argument("--coordinator-address", type=str, default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--platform", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="torch device; without CUDA the trainer fails "
                        "unless --platform cpu")
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--no-bf16", dest="bf16", action="store_false")
    p.add_argument("--tensorboard", action="store_true")
    p.add_argument("--inf-check", action="store_true")
    p.add_argument("--scan-oom", action="store_true",
                   help="before training, run one forward and backward on "
                        "the largest bucket shape to surface OOM early "
                        "(reference --scan-oom, train_zipvoice.py:798-848)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler trace (Chrome JSON) of "
                        "batches 10-14 of this run into this dir")
    p.add_argument("--print-diagnostics", action="store_true")
    return p


def check_flags(args) -> None:
    """Raise ``NotImplementedError`` for a flag whose part waits."""
    for name, item in _WAITING.items():
        if getattr(args, name, None):
            raise NotImplementedError(
                f"--{name.replace('_', '-')} waits for {item}")
    if (args.num_data_parallel or 1) > 1:
        raise NotImplementedError(
            "--num-data-parallel > 1 waits for multi-process training "
            "(ROADMAP A5e)")
    if args.per_host_data == "on":
        raise NotImplementedError(
            "--per-host-data on waits for multi-process training "
            "(ROADMAP A5e)")


def build_model(args, tokenizer, dtype, device="cuda"):
    """(model, config): the ``--model-name`` model built from
    ``--model-config`` (or the base config) with random weights drawn from
    ``--seed``, f32 parameters computing in ``dtype``, on ``device``, in
    train mode's layout (``build_zipvoice(train=True)``)."""
    from zipvoice_torch.bin.make_model_dir import BASE_CONFIG
    from zipvoice_torch.models.zipvoice import build_zipvoice
    from zipvoice_torch.utils.checkpoint_io import DIALOG_MODELS, MODEL_CLASSES

    if args.model_config:
        with open(args.model_config) as f:
            cfg = json.load(f)
            cfg = cfg.get("model", cfg)
    else:
        cfg = dict(BASE_CONFIG)
    extra = {}
    if args.model_name in DIALOG_MODELS:
        extra = dict(spk_a_id=tokenizer.spk_a_id, spk_b_id=tokenizer.spk_b_id)
    model = build_zipvoice(
        model_class=MODEL_CLASSES[args.model_name], device=device,
        dtype=dtype, seed=args.seed, train=True,
        vocab_size=tokenizer.vocab_size, pad_id=tokenizer.pad_id,
        **cfg, **extra,
    )
    return model, cfg


def load_init_state(path: str):
    """The model ``state_dict`` of a ``.pt``/``.safetensors`` file or of a
    checkpoint directory."""
    from zipvoice_torch.utils import checkpoint_io

    if os.path.isdir(path):
        return checkpoint_io.load_checkpoint(path)[0]
    return checkpoint_io.load_torch_state_dict(path)


def make_train_sampler(args):
    """(sampler, cuts or None): the static sampler over the (muxed) cuts in
    [min-len, max-len], or with ``--streaming`` the lazy one."""
    from zipvoice_torch.data.manifest import (
        iter_manifest,
        mux,
        mux_iter,
        read_manifest,
    )
    from zipvoice_torch.data.sampler import (
        DynamicBucketingSampler,
        StreamingBucketingSampler,
    )

    if args.streaming:
        paths = list(args.train_manifest)
        weights = args.train_weight or [1.0] * len(paths)

        def cuts_fn(epoch):
            if len(paths) > 1:
                base = mux_iter([lambda p=p: iter_manifest(p) for p in paths],
                                weights, seed=args.seed + epoch)
            else:
                base = iter_manifest(paths[0])
            return (c for c in base
                    if args.min_len <= c.duration <= args.max_len)

        return StreamingBucketingSampler(
            cuts_fn, max_duration=args.max_duration,
            num_buckets=args.num_buckets, shuffle=True, seed=args.seed,
            drop_last=True, shuffle_buffer=args.shuffle_buffer,
        ), None
    manifests = [read_manifest(m) for m in args.train_manifest]
    weights = args.train_weight or [len(m) for m in manifests]
    cuts = (mux(manifests, weights, seed=args.seed) if len(manifests) > 1
            else manifests[0])
    cuts = [c for c in cuts if args.min_len <= c.duration <= args.max_len]
    logging.info(f"training cuts: {len(cuts)}")
    return DynamicBucketingSampler(
        cuts, max_duration=args.max_duration, num_buckets=args.num_buckets,
        shuffle=True, seed=args.seed, drop_last=True,
    ), cuts


def batches_per_epoch(args, sampler, cuts) -> float:
    """The Eden epoch axis: the exact count of epoch 0's batches (a
    metadata-only pass), re-based to hours of audio with ``--lr-hours``."""
    if args.streaming:
        hours = sum(c.duration for c in sampler.cuts_fn(0)) / 3600
        n = max(1, sampler.count_batches())
    else:
        hours = sum(c.duration for c in cuts) / 3600
        n = max(1, sum(1 for _ in sampler))
    if args.lr_hours > 0:
        return args.lr_hours / (hours / n)
    return n


def on_device(batch, device):
    """The model's inputs of a numpy batch, on ``device``."""
    return {
        "tokens": torch.from_numpy(batch["tokens"]).long().to(device),
        "tokens_lens": torch.from_numpy(batch["tokens_lens"]).long().to(
            device),
        "features": torch.from_numpy(batch["features"]).to(device),
        "features_lens": torch.from_numpy(batch["features_lens"]).long().to(
            device),
    }


def generator_state(gens):
    return {"host": gens.host.get_state(), "device": gens.device.get_state()}


def set_generator_state(gens, state) -> None:
    gens.host.set_state(state["host"])
    gens.device.set_state(state["device"])


def resume_sampler_state(state: dict, epoch: int) -> dict:
    """The saved sampler state to resume ``epoch`` from: its position when
    it was saved inside that epoch, else the start of the epoch (an
    epoch-N checkpoint holds the end of epoch N, whose batch count must not
    be skipped in epoch N+1)."""
    if state["epoch"] != epoch:
        state = dict(state, epoch=epoch, batch=0)
    return state


class Profiler:
    """A torch.profiler trace of batches 10-14 of this run (counted from
    the invocation, so it also fires on resumed runs), written as Chrome
    JSON into ``out_dir``."""

    def __init__(self, out_dir):
        self.out_dir, self.prof, self.batches = out_dir, None, 0

    def after_batch(self) -> None:
        if self.out_dir is None:
            return
        self.batches += 1
        if self.batches == 10 and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            logging.info(f"profiler: tracing to {self.out_dir}")
        elif self.prof is not None and self.batches >= 15:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        self.prof.__exit__(None, None, None)
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        logging.info(f"profiler: trace saved to {path}")


def main(argv=None):
    """Train; returns the history, one dict a step: epoch, step, loss,
    grad_norm, wall seconds, frames, cut ids, batch shape (B, S, T)."""
    args = get_parser().parse_args(argv)
    check_flags(args)

    from zipvoice_torch.data.dataset import (
        FRAME_BUCKETS,
        SpeechSynthesisDataset,
        prefetch_batches,
    )
    from zipvoice_torch.data.manifest import read_manifest
    from zipvoice_torch.data.sampler import DynamicBucketingSampler
    from zipvoice_torch.frontend.tokenizer import get_tokenizer
    from zipvoice_torch.train.averaging import (
        init_model_avg,
        update_averaged_model,
    )
    from zipvoice_torch.train.optim import ScaledAdam, eden_schedule
    from zipvoice_torch.train.train_step import make_eval_step, make_train_step
    from zipvoice_torch.utils import checkpoint_io
    from zipvoice_torch.utils.device import resolve_device
    from zipvoice_torch.utils.metrics_tracker import (
        MetricsTracker,
        setup_logger,
    )
    from zipvoice_torch.utils.provenance import (
        device_memory_stats,
        write_provenance,
    )
    from zipvoice_torch.utils.structural_loaders import (
        copy_proj_three_channel,
        extend_vocab,
    )

    device = resolve_device(args.platform)
    exp_dir = Path(args.exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    # console + log file (reference common.py:448-498)
    setup_logger(str(exp_dir), 0)
    # a self-describing exp dir (reference train_zipvoice.py:887-889)
    shutil.copyfile(args.token_file, exp_dir / "tokens.txt")
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    tokenizer = get_tokenizer(args.tokenizer, args.token_file, args.lang)
    model, cfg = build_model(args, tokenizer, dtype, device)
    (exp_dir / "model.json").write_text(json.dumps({"model": cfg}, indent=2))
    write_provenance(exp_dir, {"model_name": args.model_name})

    # ---- data -------------------------------------------------------------
    sampler, cuts = make_train_sampler(args)
    stereo = args.model_name == "zipvoice_dialog_stereo"
    dataset = SpeechSynthesisDataset(
        tokenizer=tokenizer, on_the_fly_feats=args.on_the_fly_feats,
        feat_scale=args.feat_scale, num_channels=2 if stereo else 1,
        return_text=True,
    )
    dataset_mixed = SpeechSynthesisDataset(
        tokenizer=tokenizer, on_the_fly_feats=args.on_the_fly_feats,
        feat_scale=args.feat_scale, num_channels=1, return_text=True,
    ) if stereo else None
    dev_sampler = None
    if args.dev_manifest:
        dev_sampler = DynamicBucketingSampler(
            read_manifest(args.dev_manifest), max_duration=args.max_duration,
            shuffle=False, seed=args.seed,
        )
    sample_batch = None
    for cuts_batch in sampler:
        sample_batch = dataset(cuts_batch[:2])
        break
    if sample_batch is None:
        raise ValueError("the training manifests hold no batch (too few "
                         "cuts in [--min-len, --max-len] for a bucket to "
                         "fill --max-duration)")

    # ---- weights ----------------------------------------------------------
    feat_dim = cfg.get("feat_dim", 100)
    if args.init_from_base or args.init_from_dialog:
        src = args.init_from_base or args.init_from_dialog
        sd = load_init_state(src)
        if args.init_from_base:
            sd = extend_vocab(sd, tokenizer.vocab_size,
                              rng=np.random.RandomState(args.seed),
                              feat_dim=feat_dim)
            logging.info(f"dialog init from base ckpt {src} (vocab extended)")
        else:
            sd = copy_proj_three_channel(sd, feat_dim=feat_dim)
            logging.info(f"stereo init from dialog ckpt {src} (two-stream "
                         f"projections duplicated)")
        model.load_state_dict(sd, strict=True)
    elif args.checkpoint:
        model.load_state_dict(load_init_state(args.checkpoint), strict=True)
        logging.info(f"initialized from {args.checkpoint}")
    elif stereo:
        # the JAX trainer grafts the mixed projection pair into its init
        # (:401-420); the port's two-stream decoder builds both pairs
        logging.info("stereo from-scratch init: both projection pairs "
                     "built with the model")
    n_params = sum(p.numel() for p in model.parameters())
    logging.info(f"model parameters: {n_params / 1e6:.1f}M")

    # ---- optimizer and steps ----------------------------------------------
    per_epoch = batches_per_epoch(args, sampler, cuts)
    if args.scheduler == "fixed":
        # reference FixedLRScheduler (lr_scheduler.py:187-204)
        schedule = args.base_lr
    else:
        schedule = eden_schedule(
            base_lr=args.base_lr, lr_batches=args.lr_batches,
            lr_epochs=args.lr_epochs, warmup_batches=args.warmup_batches,
            batches_per_epoch=per_epoch,
        )
    optimizer = ScaledAdam(model.parameters(), lr=schedule,
                           clipping_scale=args.clipping_scale)
    # any checkpoint, dialog or stereo init is a finetune in the
    # reference's sense (common.py:310-317)
    finetune = args.finetune or bool(
        args.checkpoint or args.init_from_base or args.init_from_dialog)
    train_step = make_train_step(
        model, optimizer, condition_drop_ratio=args.condition_drop_ratio,
        dropout_rate=args.dropout_rate, schedules=args.schedules,
        max_duration=args.max_duration, world_size=1,
        ref_duration=args.ref_duration, finetune=finetune,
        seed=args.seed + 1,
    )
    eval_step = make_eval_step(model)
    model_avg = init_model_avg(model.state_dict())

    if args.start_epoch > 1:
        resume = exp_dir / f"epoch-{args.start_epoch - 1}"
        sd, train_state, extra = checkpoint_io.load_checkpoint(str(resume))
        model.load_state_dict(sd, strict=True)
        optimizer.load_state_dict(train_state["optimizer"])
        train_step.step = train_state["step"]
        set_generator_state(train_step.gens, train_state["generators"])
        if extra and "sampler" in extra:
            sampler.load_state_dict(
                resume_sampler_state(extra["sampler"], args.start_epoch))
        avg_path = str(resume) + "-avg"
        if os.path.exists(avg_path):
            model_avg = {k: v.to(device) for k, v in
                         checkpoint_io.load_checkpoint(avg_path)[0].items()}
        logging.info(f"resumed from {resume} at step {train_step.step}")

    def save(name: str) -> None:
        path = exp_dir / name
        checkpoint_io.save_checkpoint(
            str(path), model.state_dict(),
            train_state={"optimizer": optimizer.state_dict(),
                         "step": train_step.step,
                         "generators": generator_state(train_step.gens)},
            extra={"sampler": sampler.state_dict(),
                   "batch_idx_train": train_step.step,
                   "average_period": args.average_period},
        )
        # every checkpoint carries its running average, so that
        # generate_averaged_model works on iteration saves (reference
        # checkpoint.py:38-104)
        checkpoint_io.save_checkpoint(str(path) + "-avg", model_avg)

    if args.scan_oom:
        # the largest frame bucket at the batch size the duration budget
        # implies: one forward and backward, no update
        T_max = max(t for t in FRAME_BUCKETS
                    if t <= args.max_len * 93.75 + 128)
        B_max = max(1, int(args.max_duration // args.min_len))
        logging.info(f"--scan-oom probe: B={B_max}, T={T_max}")
        F = sample_batch["features"].shape[2]
        probe = {
            "tokens": np.zeros((B_max, 64), np.int32),
            "tokens_lens": np.full((B_max,), 8, np.int32),
            "features": np.zeros((B_max, T_max, F), np.float32),
            "features_lens": np.full((B_max,), T_max, np.int32),
        }
        from zipvoice_torch.models.zipformer import TrainGenerators
        from zipvoice_torch.train.train_step import draw_inputs

        # generators of its own: the probe leaves the training draws as
        # they would be without it
        gens = TrainGenerators(args.seed, device)
        b = on_device(probe, device)
        t, noise, span = draw_inputs(gens, b)
        model(**b, noise=noise, t=t, speech_condition_mask=span, gens=gens,
              train=True).backward()
        optimizer.zero_grad(set_to_none=True)
        mem = device_memory_stats(device)
        logging.info("--scan-oom ok" + (
            f" (peak {mem['peak_bytes_in_use'] / 2**30:.2f} GiB)"
            if mem else ""))

    tb = None
    if args.tensorboard:
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb = SummaryWriter(str(exp_dir / "tensorboard"))
        except ImportError:
            logging.warning("tensorboard unavailable")

    # ---- loop -------------------------------------------------------------
    profiler = Profiler(args.profile_dir)
    tracker = MetricsTracker()
    t_start = time.time()
    saved_iters = []
    history = []
    # under --num-iters the iteration budget, not the epoch count, ends
    # training (reference num-iters mode)
    last_epoch = args.num_epochs if not args.num_iters else 10**9
    for epoch in range(args.start_epoch, last_epoch + 1):
        sampler.set_epoch(epoch)
        if stereo:
            # alternate stereo (se_weight=1) and mixed (se_weight=0) batches
            # (reference train_zipvoice_dialog_stereo.py:349-378)
            batch_iter = (
                ((dataset_mixed if i % 2 else dataset)(c),
                 {"se_weight": 0.0 if i % 2 else 1.0})
                for i, c in enumerate(sampler)
            )
        else:
            batch_iter = ((b, {}) for b in prefetch_batches(
                sampler, dataset, num_workers=args.num_workers))
        for batch, kw in batch_iter:
            t0 = time.perf_counter()
            try:
                metrics = train_step(on_device(batch, device), **kw)
                loss = float(metrics["loss"])
            except Exception:
                # the offending batch and model, for a post-mortem
                # (reference train_zipvoice.py:536-549,769-795)
                bad = exp_dir / "bad-batch-0.npz"
                np.savez(bad, **{k: v for k, v in batch.items()
                                 if isinstance(v, np.ndarray)})
                checkpoint_io.save_checkpoint(str(exp_dir / "bad-model"),
                                              model.state_dict())
                logging.error(f"step failed; batch saved to {bad}")
                raise
            wall = time.perf_counter() - t0
            step = train_step.step
            frames = int(batch["features_lens"].sum())
            grad_norm = float(metrics["grad_norm"])
            history.append(dict(
                epoch=epoch, step=step, loss=loss, grad_norm=grad_norm,
                wall=wall, frames=frames, ids=batch["ids"],
                shape=(len(batch["features"]), batch["tokens"].shape[1],
                       batch["features"].shape[1])))
            # frame-normalized tracking (reference common.py:57-146)
            tracker["loss"] += loss * frames
            tracker["grad_norm"] += grad_norm * frames
            tracker["frames"] += frames
            tracker["utterances"] += int(batch["features"].shape[0])
            profiler.after_batch()

            if step % args.log_interval == 0:
                lr = schedule(step) if callable(schedule) else schedule
                speed = tracker.get("frames", 0) / max(
                    time.time() - t_start, 1e-9)
                mem = device_memory_stats(device)
                mem_s = (f" mem {mem['peak_bytes_in_use'] / 2**30:.2f}GiB "
                         f"peak" if mem else "")
                logging.info(
                    f"epoch {epoch} step {step}: loss {loss:.4f} "
                    f"[{tracker}] lr {lr:.2e} frames/s {speed:.0f}{mem_s}")
                if tb:
                    tb.add_scalar("train/loss", loss, step)
                    tb.add_scalar("train/lr", lr, step)
                    tracker.write_summary(tb, "train", step)
                tracker, t_start = MetricsTracker(), time.time()

            if step % args.average_period == 0:
                model_avg = update_averaged_model(
                    model_avg, model.state_dict(), step, args.average_period)

            if args.save_every_n > 0 and step % args.save_every_n == 0:
                save(f"checkpoint-{step}")
                saved_iters.append(exp_dir / f"checkpoint-{step}")
                while len(saved_iters) > args.keep_last_k:
                    old = saved_iters.pop(0)
                    shutil.rmtree(old, ignore_errors=True)
                    shutil.rmtree(str(old) + "-avg", ignore_errors=True)

            if args.num_iters and step >= args.num_iters:
                break

            if dev_sampler and step % args.valid_interval == 0:
                v_loss, v_frames = 0.0, 0
                for i, vb in enumerate(prefetch_batches(dev_sampler,
                                                        dataset)):
                    f = int(vb["features_lens"].sum())
                    v_loss += float(eval_step(on_device(vb, device))) * f
                    v_frames += f
                    if i >= 20:
                        break
                v_loss /= max(v_frames, 1)
                logging.info(f"validation: loss {v_loss:.4f}")
                if tb:
                    tb.add_scalar("valid/loss", v_loss, step)

        if args.num_iters and train_step.step >= args.num_iters:
            save(f"checkpoint-{train_step.step}")
            logging.info(f"reached --num-iters {args.num_iters}; stopping")
            break
        save(f"epoch-{epoch}")
        logging.info(f"saved {exp_dir / f'epoch-{epoch}'}")

    profiler.stop()
    logging.info("training done")
    return history


if __name__ == "__main__":
    main()
