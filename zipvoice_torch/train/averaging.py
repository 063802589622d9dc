"""Running and offline model-parameter averaging (counterpart of
``zipvoice_tpu/train/averaging.py``).

Reference: zipvoice/utils/checkpoint.py:295-360,480-511.  The running
average is f64, as the reference casts model_avg to double; it is kept on
the device of the ``state_dict`` it starts from and touched once per
``average_period`` steps.  The arithmetic is the JAX package's, operation
for operation, on f64 tensors in place of its host numpy arrays.
"""

from typing import Dict, Mapping

import torch

StateDict = Dict[str, torch.Tensor]


def init_model_avg(state_dict: Mapping[str, torch.Tensor]) -> StateDict:
    """An f64 copy of ``state_dict``, on its device."""
    return {k: v.detach().to(torch.float64, copy=True)
            for k, v in state_dict.items()}


@torch.no_grad()
def update_averaged_model(model_avg: StateDict,
                          state_dict: Mapping[str, torch.Tensor],
                          batch_idx: int, average_period: int) -> StateDict:
    """model_avg <- model_avg * (1 - w) + params * w, w = average_period /
    batch_idx (reference checkpoint.py:480-511)."""
    w = average_period / max(batch_idx, 1)
    return {k: a * (1.0 - w) + state_dict[k].detach().to(a.device,
                                                         torch.float64) * w
            for k, a in model_avg.items()}


@torch.no_grad()
def average_checkpoints_with_averaged_model(
    avg_start: Mapping[str, torch.Tensor],
    avg_end: Mapping[str, torch.Tensor],
    batch_idx_start: int, batch_idx_end: int, average_period: int,
) -> StateDict:
    """The average over (start, end]: (end * b_end - start * b_start) /
    interval (reference checkpoint.py:295-360), as f32 tensors."""
    b_start = (batch_idx_start // average_period) * average_period
    b_end = (batch_idx_end // average_period) * average_period
    interval = b_end - b_start
    assert interval > 0, (b_start, b_end)
    weight_end = b_end / interval
    weight_start = 1 - weight_end
    return {
        k: ((e.to(torch.float64)
             + avg_start[k].to(torch.float64) * (weight_start / weight_end))
            * weight_end).to(torch.float32)
        for k, e in avg_end.items()
    }
