"""Two-stage distillation training for ZipVoice-Distill (counterpart of
``zipvoice_tpu/bin/train_zipvoice_distill.py``; reference
zipvoice/bin/train_zipvoice_distill.py).

Stage "first": a frozen base-ZipVoice teacher (``--teacher-checkpoint``,
the averaged base model), the student initialized from the same weights.
Stage "second": the teacher is an EMA copy of the student, updated every
step.

  python -m zipvoice_torch.bin.train_zipvoice_distill \\
    --distill-stage first --teacher-checkpoint exp/zipvoice/model.pt \\
    --train-manifest ... --token-file ... --exp-dir exp/distill_1

The teacher runs in eval mode with gradients off (on the card, through the
inference attention kernel); the student in train mode (through the
trainable pair).  The multi-process flags are the base trainer's
(``bin/train_zipvoice.py``): every process holds the same teacher, and the
EMA teacher of stage "second" stays the same on every process.
"""

import copy
import json
import logging
import shutil
import time
from pathlib import Path

import torch


def get_parser():
    from zipvoice_torch.bin.train_zipvoice import get_parser as base_parser

    p = base_parser()
    p.add_argument("--distill-stage", type=str, required=True,
                   choices=["first", "second"])
    p.add_argument("--teacher-checkpoint", type=str, default=None,
                   help="required for stage first (base ZipVoice weights)")
    p.add_argument("--ema-decay", type=float, default=0.9999)
    return p


def main(argv=None):
    """Distill; returns the history, one dict a step: epoch, step, loss,
    ref_loss, wall seconds, frames, cut ids, batch shape (B, S, T) (the
    frames, ids and shape of this process's rows)."""
    from zipvoice_torch.bin.train_zipvoice import open_group
    from zipvoice_torch.parallel import mesh

    args = get_parser().parse_args(argv)
    args.model_name = "zipvoice_distill"
    device, rank, world = open_group(args)
    try:
        return distill(args, device, rank, world)
    finally:
        mesh.destroy()


def distill(args, device, rank: int, world: int):
    """``main``'s distillation, as process ``rank`` of ``world`` on
    ``device``."""
    from zipvoice_torch.bin.train_zipvoice import (
        build_model,
        load_init_state,
        make_train_sampler,
        on_device,
        take_rows,
        use_local_rows,
    )
    from zipvoice_torch.data.dataset import (
        SpeechSynthesisDataset,
        prefetch_batches,
    )
    from zipvoice_torch.frontend.tokenizer import get_tokenizer
    from zipvoice_torch.models.zipformer import set_compute_dtype
    from zipvoice_torch.models.zipvoice import ZipVoice
    from zipvoice_torch.parallel import mesh
    from zipvoice_torch.train.averaging import (
        init_model_avg,
        update_averaged_model,
    )
    from zipvoice_torch.train.distill import (
        ema_update,
        make_distill_train_step,
    )
    from zipvoice_torch.train.optim import ScaledAdam, eden_schedule
    from zipvoice_torch.utils import checkpoint_io
    from zipvoice_torch.utils.metrics_tracker import setup_logger

    exp_dir = Path(args.exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    setup_logger(str(exp_dir), rank)
    # every write is process 0's
    primary = rank == 0
    if primary:
        shutil.copyfile(args.token_file, exp_dir / "tokens.txt")
    dtype = torch.bfloat16 if args.bf16 else torch.float32

    tokenizer = get_tokenizer(args.tokenizer, args.token_file, args.lang)
    student, cfg = build_model(args, tokenizer, dtype, device)
    if primary:
        (exp_dir / "model.json").write_text(
            json.dumps({"model": cfg}, indent=2))

    # ---- teacher / student initialization ---------------------------------
    if not (args.teacher_checkpoint or args.checkpoint):
        raise ValueError("need --teacher-checkpoint (stage first) or "
                         "--checkpoint")
    if args.distill_stage == "first" and not args.teacher_checkpoint:
        raise ValueError("stage first needs --teacher-checkpoint")
    sd = load_init_state(args.checkpoint or args.teacher_checkpoint)
    # a base checkpoint lacks the student's guidance-scale embedding: it
    # keeps the student's own seeded init
    missing = {k: v for k, v in student.state_dict().items() if k not in sd}
    if any(not k.startswith("fm_decoder.guidance_scale_embed.")
           for k in missing):
        raise KeyError(f"checkpoint lacks {sorted(missing)[:8]}")
    student.load_state_dict({**missing, **sd}, strict=True)
    # every process starts from process 0's weights
    mesh.broadcast_params(student)

    if args.distill_stage == "first":
        with torch.device("meta"):
            teacher = ZipVoice(**cfg, vocab_size=tokenizer.vocab_size,
                               pad_id=tokenizer.pad_id)
        teacher.load_state_dict(load_init_state(args.teacher_checkpoint),
                                strict=True, assign=True)
        # frozen: its weights are cast to the compute dtype once
        for backbone in (teacher.fm_decoder, teacher.text_encoder):
            set_compute_dtype(backbone, dtype)
        teacher = teacher.to(device)
    else:
        teacher = copy.deepcopy(student)
    teacher.eval().requires_grad_(False)

    # ---- data -------------------------------------------------------------
    sampler, cuts = make_train_sampler(args)
    dataset = SpeechSynthesisDataset(
        tokenizer=tokenizer, on_the_fly_feats=args.on_the_fly_feats,
        feat_scale=args.feat_scale, return_text=True,
    )
    use_local_rows(args, rank, world, dataset)

    schedule = eden_schedule(
        base_lr=args.base_lr, lr_batches=args.lr_batches,
        lr_epochs=args.lr_epochs, warmup_batches=args.warmup_batches,
        batches_per_epoch=max(1, len(sampler)),
    )
    optimizer = ScaledAdam(student.parameters(), lr=schedule,
                           clipping_scale=args.clipping_scale)
    step_fn = make_distill_train_step(
        student, teacher, optimizer, stage=args.distill_stage,
        schedules=args.schedules, max_duration=args.max_duration,
        ref_duration=args.ref_duration, seed=args.seed,
    )
    # process 0 keeps the running average, which it alone writes
    model_avg = init_model_avg(student.state_dict()) if primary else None
    teacher_params = dict(teacher.named_parameters())
    student_params = dict(student.named_parameters())

    def save(name: str) -> None:
        """Process 0 writes; every process waits for it."""
        path = exp_dir / name
        if not primary:
            mesh.barrier()
            return
        checkpoint_io.save_checkpoint(
            str(path), student.state_dict(),
            train_state={"optimizer": optimizer.state_dict(),
                         "step": step_fn.step},
            extra={"batch_idx_train": step_fn.step,
                   "average_period": args.average_period},
        )
        checkpoint_io.save_checkpoint(str(path) + "-avg", model_avg)
        mesh.barrier()

    history = []
    tot_loss, tot_frames, t0 = 0.0, 0, time.time()
    last_epoch = args.num_epochs if not args.num_iters else 10**9
    for epoch in range(args.start_epoch, last_epoch + 1):
        sampler.set_epoch(epoch)
        for batch in prefetch_batches(sampler, dataset):
            batch = take_rows(batch, rank, world)
            t_step = time.perf_counter()
            metrics = step_fn(on_device(batch, device))
            if args.distill_stage == "second":
                ema_update(teacher_params, student_params, args.ema_decay,
                           inplace=True)
            loss = float(metrics["loss"])
            wall = time.perf_counter() - t_step
            step = step_fn.step
            frames = int(batch["features_lens"].sum())
            history.append(dict(
                epoch=epoch, step=step, loss=loss,
                ref_loss=float(metrics["ref_loss"]), wall=wall,
                frames=frames, ids=batch["ids"],
                shape=(len(batch["features"]), batch["tokens"].shape[1],
                       batch["features"].shape[1])))
            tot_loss += loss * frames
            tot_frames += frames
            if step % args.log_interval == 0:
                logging.info(
                    f"epoch {epoch} step {step}: loss {loss:.5f} "
                    f"ref_loss {history[-1]['ref_loss']:.4f} "
                    f"(avg {tot_loss / max(tot_frames, 1):.5f}) "
                    f"frames/s {tot_frames / max(time.time() - t0, 1e-9):.0f}"
                )
                tot_loss, tot_frames, t0 = 0.0, 0, time.time()
            if step % args.average_period == 0 and primary:
                model_avg = update_averaged_model(
                    model_avg, student.state_dict(), step,
                    args.average_period)
            if args.save_every_n > 0 and step % args.save_every_n == 0:
                save(f"checkpoint-{step}")
            if args.num_iters and step >= args.num_iters:
                break
        if args.num_iters and step_fn.step >= args.num_iters:
            save(f"checkpoint-{step_fn.step}")
            logging.info(f"reached --num-iters {args.num_iters}; stopping")
            break
        save(f"epoch-{epoch}")
        logging.info(f"saved epoch-{epoch}")
    logging.info("distillation done")
    return history


if __name__ == "__main__":
    main()
