"""The training and evaluation steps of the ZipVoice model family
(counterpart of ``zipvoice_tpu/train/train_step.py``).

Parameters stay f32; the matmuls and convolutions compute in the model's
compute dtype (bf16 on the card, ``build_zipvoice(train=True)``), with no
loss scaling.  Each step draws t ~ U(0, 1), the gaussian noise, the
speech-condition span mask and the CFG text-drop mask from the device
generator of its ``TrainGenerators``, and every regularizer coin from the
host generator, so a step never waits on the device until the caller reads
its metrics.

Under a process group (``parallel/mesh.py``) each process holds its rows of
the global batch, draws at the global batch and keeps its rows, and takes
its share of the global loss; one all-reduce after the backward sums the
gradients and the loss, so every process takes the same update.
"""

from typing import Callable, Dict, Optional

import torch

from zipvoice_torch.models.conditioning import (
    condition_time_mask,
    condition_time_mask_draws,
)
from zipvoice_torch.models.zipformer import TrainGenerators
from zipvoice_torch.ops.schedule import adjusted_batch_count
from zipvoice_torch.parallel import mesh


def draw_inputs(gens, batch, t=None):
    """A step's flow times (B, 1, 1) (unless given), noise and span mask,
    drawn from ``gens.device`` at the global batch and sliced to this
    process's rows (``gens.rows``)."""
    feats = batch["features"]
    B, T, F = feats.shape
    dev, g = feats.device, gens.device
    total, rows = gens.batch_rows(B)
    if t is None:
        t = torch.rand((total, 1, 1), generator=g, device=dev)[rows]
    noise = torch.randn((total, T, F), generator=g, device=dev)[rows]
    u_size, u_start = condition_time_mask_draws(g, total, dev)
    span = condition_time_mask(u_size[rows], u_start[rows],
                               batch["features_lens"], T)
    return t, noise, span


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    condition_drop_ratio: float = 0.2,
    dropout_rate: Optional[float] = 0.1,
    schedules: bool = False,
    max_duration: float = 50.0,
    world_size: int = 1,
    ref_duration: float = 50.0,
    finetune: bool = False,
    seed: int = 0,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Returns ``train_step(batch) -> {"loss", "grad_norm"}``: one loss,
    backward and ``optimizer.step()``.  The metrics are device scalars
    (``grad_norm`` is the global norm of the unclipped gradients).

    batch: tokens (B, S) int, tokens_lens (B,), features (B, T, F) (already
    scaled by the feature scale), features_lens (B,), all on the model's
    device.  ``train_step.step`` counts the steps taken; with
    ``schedules=True`` it drives the batch-count schedules through the
    adjusted batch count, and ``dropout_rate=None`` then follows the
    scheduled 0.3 -> 0.1 ramp.  ``train_step.gens`` holds the generators,
    seeded from ``seed``.  Keyword arguments of a call go to that call's
    forward (the stereo model's ``se_weight``).
    """
    device = next(model.parameters()).device
    gens = TrainGenerators(seed, device)

    def train_step(batch, **model_kwargs):
        B = batch["features"].shape[0]
        gens.rows = mesh.batch_rows(B)
        t, noise, span = draw_inputs(gens, batch)
        total, rows = gens.batch_rows(B)
        cond_drop = torch.rand((total,), generator=gens.device,
                               device=device)[rows] <= condition_drop_ratio
        batch_count = None
        if schedules:
            batch_count = adjusted_batch_count(
                train_step.step, max_duration=max_duration,
                world_size=world_size, ref_duration=ref_duration,
                finetune=finetune,
            )
        optimizer.zero_grad(set_to_none=True)
        loss = model(
            tokens=batch["tokens"], tokens_lens=batch["tokens_lens"],
            features=batch["features"], features_lens=batch["features_lens"],
            noise=noise, t=t, condition_drop_mask=cond_drop,
            speech_condition_mask=span, gens=gens, train=True,
            dropout_rate=dropout_rate, batch_count=batch_count,
            **model_kwargs,
        )
        loss.backward()
        loss = loss.detach()
        # under a process group: the global batch's gradient and loss,
        # from one all-reduce
        mesh.all_reduce_grads(model.parameters(), loss)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        grad_norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads))
        optimizer.step()
        train_step.step += 1
        return {"loss": loss, "grad_norm": grad_norm}

    train_step.step = 0
    train_step.gens = gens
    return train_step


def make_eval_step(model: torch.nn.Module, seed: int = 0) -> Callable:
    """``eval_step(batch) -> loss``: the validation loss with the stratified
    t grid t_i = i / B, and the noise and span mask drawn from ``seed``,
    the same for every call."""

    @torch.no_grad()
    def eval_step(batch):
        device = batch["features"].device
        B = batch["features"].shape[0]
        gens = TrainGenerators(seed, device)
        gens.rows = mesh.batch_rows(B)
        total, rows = gens.batch_rows(B)
        t = torch.arange(total, dtype=torch.float32, device=device) / total
        t, noise, span = draw_inputs(gens, batch, t=t[rows, None, None])
        return model(
            tokens=batch["tokens"], tokens_lens=batch["tokens_lens"],
            features=batch["features"], features_lens=batch["features_lens"],
            noise=noise, t=t, speech_condition_mask=span, gens=gens,
            train=False,
        )

    return eval_step
