"""Frame-normalized multi-metric tracking (reference utils/common.py:57-146
MetricsTracker) and per-process log files (common.py:448-498): the port's
copy of ``zipvoice_tpu/utils/metrics_tracker.py``.

In multi-process training each process tracks its own rows' frames and
utterances (the loss and the gradient norm are already the global batch's),
and ``reduced`` sums the trackers over the process group when they are
logged, as the reference all-reduces them across DDP ranks.
"""

import logging
import os
from collections import defaultdict
from typing import Dict

import torch

from zipvoice_torch.parallel import mesh


class MetricsTracker(defaultdict):
    """dict of metric sums; 'frames' (and 'utterances') act as normalizers.
    Addition merges trackers; str() prints frame-normalized values."""

    def __init__(self):
        super().__init__(float)

    def __add__(self, other: "MetricsTracker") -> "MetricsTracker":
        ans = MetricsTracker()
        for k, v in self.items():
            ans[k] = v
        for k, v in other.items():
            ans[k] = ans[k] + v
        return ans

    def __mul__(self, alpha: float) -> "MetricsTracker":
        ans = MetricsTracker()
        for k, v in self.items():
            ans[k] = v * alpha
        return ans

    def __str__(self) -> str:
        frames = max(self.get("frames", 0.0), 1.0)
        parts = []
        for k, v in sorted(self.items()):
            if k in ("frames", "utterances"):
                continue
            parts.append(f"{k}={v / frames:.4g}")
        parts.append(f"over {int(self.get('frames', 0))} frames")
        return ", ".join(parts)

    def norm_items(self) -> Dict[str, float]:
        frames = max(self.get("frames", 0.0), 1.0)
        return {
            k: v / frames
            for k, v in self.items()
            if k not in ("frames", "utterances")
        }

    def reduced(self, device="cpu") -> "MetricsTracker":
        """The trackers of the process group's processes summed (one
        all-reduce, every process taking part), or this one alone."""
        if not mesh.reducing():
            return self
        keys = sorted(self)
        values = mesh.all_reduce_(torch.tensor(
            [self[k] for k in keys], dtype=torch.float64, device=device))
        ans = MetricsTracker()
        for k, v in zip(keys, values.tolist()):
            ans[k] = v
        return ans

    def write_summary(self, tb_writer, prefix: str, step: int) -> None:
        if tb_writer is None:
            return
        for k, v in self.norm_items().items():
            tb_writer.add_scalar(f"{prefix}/{k}", v, step)


def setup_logger(
    exp_dir: str, process_index: int = 0, level=logging.INFO
) -> None:
    """Console + per-process log file (the reference writes
    log/log-train-<rank>, common.py:448-498)."""
    log_dir = os.path.join(exp_dir, "log")
    os.makedirs(log_dir, exist_ok=True)
    fmt = "%(asctime)s %(levelname)s [p%(process)d] %(message)s"
    handlers = [
        logging.StreamHandler(),
        logging.FileHandler(
            os.path.join(log_dir, f"log-train-{process_index}")
        ),
    ]
    logging.basicConfig(
        level=level, format=fmt, handlers=handlers, force=True
    )
