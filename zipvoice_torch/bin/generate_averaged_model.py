"""Produce a release model by averaging checkpoints (counterpart of
``zipvoice_tpu/bin/generate_averaged_model.py``; reference
zipvoice/bin/generate_averaged_model.py: offline range averaging over the
f64 running averages saved with each checkpoint).

  python -m zipvoice_torch.bin.generate_averaged_model \\
    --exp-dir exp/zipvoice --epoch 11 --avg 4 --out exp/zipvoice/model.pt

Writes a reference-layout ``.pt`` (``{"model": state_dict}``, f32) that
``load_model_dir`` reads beside the exp dir's ``model.json`` and
``tokens.txt``, and that ``--teacher-checkpoint`` and ``--checkpoint``
take.  ``--epoch E --avg E`` averages over the whole run: epoch 0 stands
for the start of training (batch 0).
"""

import argparse
import logging
import os
import re

import torch


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--exp-dir", type=str, required=True)
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--iter", type=int, default=None)
    p.add_argument("--avg", type=int, required=True,
                   help="number of epochs/iters before --epoch to "
                        "average over")
    p.add_argument("--out", type=str, default=None,
                   help="the .pt to write (default exp-dir/model.pt)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from zipvoice_torch.train.averaging import (
        average_checkpoints_with_averaged_model,
    )
    from zipvoice_torch.utils import checkpoint_io

    if (args.epoch is None) == (args.iter is None):
        raise ValueError("give exactly one of --epoch/--iter")
    if args.epoch is not None:
        end_name = f"epoch-{args.epoch}"
        start_name = f"epoch-{args.epoch - args.avg}"
        if args.epoch - args.avg < 0:
            raise ValueError(f"--avg {args.avg} reaches before epoch 0")
    else:
        # the existing checkpoint-* saves (reference find_checkpoints):
        # they land at multiples of --save-every-n, so start = `avg` saves
        # before the end one
        iters = sorted(
            int(m.group(1))
            for name in os.listdir(args.exp_dir)
            if (m := re.fullmatch(r"checkpoint-(\d+)", name))
            and int(m.group(1)) <= args.iter
        )
        if len(iters) <= args.avg:
            raise ValueError(
                f"need {args.avg + 1} checkpoints at or below {args.iter} "
                f"in {args.exp_dir}, found {iters}")
        end_name = f"checkpoint-{iters[-1]}"
        start_name = f"checkpoint-{iters[-1 - args.avg]}"

    def load(name):
        path = os.path.join(args.exp_dir, name)
        avg = checkpoint_io.load_checkpoint(path + "-avg")[0]
        extra = checkpoint_io.load_checkpoint(path)[2]
        return avg, extra["batch_idx_train"], extra["average_period"]

    avg_end, b_end, period = load(end_name)
    if b_end < period:
        raise ValueError(
            f"{end_name} holds {b_end} batches, fewer than its "
            f"--average-period {period}: its running average was never "
            f"updated")
    if start_name == "epoch-0":
        avg_start, b_start = {k: torch.zeros_like(v)
                              for k, v in avg_end.items()}, 0
    else:
        avg_start, b_start, _ = load(start_name)
    state = average_checkpoints_with_averaged_model(
        avg_start, avg_end, b_start, b_end, period)
    out = args.out or os.path.join(args.exp_dir, "model.pt")
    torch.save({"model": state}, out)
    logging.info(f"wrote averaged model to {out} (batches {b_start}.."
                 f"{b_end})")
    return out


if __name__ == "__main__":
    main()
