"""Distillation training step (counterpart of
``zipvoice_tpu/train/distill.py``; reference
zipvoice/bin/train_zipvoice_distill.py).

The teacher advances two chained 1-step solves t -> t+d1 -> t+d1+d2 (no
gradient); the student is trained to match the implied average velocity of
a single 1-step solve over [t, t_dest] (reference :378-515):

- stage "first": the teacher is the frozen base ZipVoice run with CFG;
  guidance_scale ~ U[0, 2);
- stage "second": the teacher is an EMA copy of the student (decay
  configurable, applied every batch, :650); guidance_scale ~ U[1, 3).

t, d1 and d2 are scalars shared across the batch and drawn each step on the
device, with the noise, the guidance scales and the span mask, from the
step's ``TrainGenerators`` (the regularizers' coins from its host
generator), so a step never waits on the device until its metrics are read.
The teacher runs in eval mode with gradients off, so on the card it takes
the inference attention kernel; the student runs in train mode, where it
takes the trainable pair.
"""

from typing import Callable, Dict, Mapping

import torch

from zipvoice_torch.models.conditioning import (
    condition_time_mask,
    condition_time_mask_draws,
    make_pad_mask,
)
from zipvoice_torch.models.zipformer import TrainGenerators
from zipvoice_torch.ops.schedule import adjusted_batch_count
from zipvoice_torch.parallel import mesh


@torch.no_grad()
def ema_update(ema_params: Mapping[str, torch.Tensor],
               new_params: Mapping[str, torch.Tensor], decay: float,
               inplace: bool = False) -> Dict[str, torch.Tensor]:
    """ema <- ema * decay + new * (1 - decay) (reference :365-375), for
    every key of ``ema_params``; into ``ema_params``' own tensors with
    ``inplace``."""
    keys = list(ema_params)
    ema = [ema_params[k] for k in keys]
    new = torch._foreach_mul([new_params[k].detach() for k in keys],
                             1 - decay)
    if inplace:
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, new)
    else:
        ema = torch._foreach_add(torch._foreach_mul(ema, decay), new)
    return dict(zip(keys, ema))


def draw_distill_inputs(gens: TrainGenerators, batch, stage: str):
    """A step's draws from ``gens.device``: the noise (B, T, F), t, d1 and
    d2 (scalars, d1 = U * min(0.3, 1 - t), d2 = U * min(0.3, 1 - t - d1)),
    the guidance scales (B, 1, 1) and the speech-condition span mask
    (B, T), 70-100% of each row."""
    feats = batch["features"]
    B, T, F = feats.shape
    dev, g = feats.device, gens.device
    # at the global batch, this process's rows (parallel/mesh.py)
    total, rows = gens.batch_rows(B)
    noise = torch.randn((total, T, F), generator=g, device=dev)[rows]
    u = torch.rand((3,), generator=g, device=dev)
    gs = torch.rand((total, 1, 1), generator=g, device=dev)[rows] * 2.0
    if stage == "second":
        gs = gs + 1.0
    u_size, u_start = condition_time_mask_draws(g, total, dev)
    span = condition_time_mask(u_size[rows], u_start[rows],
                               batch["features_lens"], T,
                               mask_percent=(0.7, 1.0))
    t = u[0]
    d1 = u[1] * torch.clamp(1 - t, max=0.3)
    d2 = u[2] * torch.clamp(1 - t - d1, max=0.3)
    return dict(noise=noise, t=t, d1=d1, d2=d2, guidance_scale=gs,
                speech_condition_mask=span)


def distill_losses(student, teacher, batch, draws, stage: str,
                   student_kw: Mapping = None):
    """(loss, ref_loss) of one distillation step on ``draws``: the masked
    MSE between the student's one-step velocity over [t, t_dest] and the
    teacher's two chained steps', and of the student's velocity against
    the flow target features - noise, each averaged over the masked frames
    and the features' width.  ``student_kw`` (train, dropout_rate,
    batch_count, gens) goes to the student's ``sample_intermediate``; the
    teacher runs as it is set, with gradients off."""
    features, features_lens = batch["features"], batch["features_lens"]
    B, T, F = features.shape
    noise, t = draws["noise"], draws["t"]
    t_mid = t + draws["d1"]
    t_dest = t_mid + draws["d2"]
    xt = features * t + noise * (1 - t)
    common = dict(
        tokens=batch["tokens"], tokens_lens=batch["tokens_lens"],
        features=features, features_lens=features_lens,
        speech_condition_mask=draws["speech_condition_mask"], num_step=1,
        guidance_scale=draws["guidance_scale"],
    )
    teacher_distill = stage == "second"
    with torch.no_grad():
        x_mid, _ = teacher.sample_intermediate(
            noise=xt, t_start=t, t_end=t_mid, distill=teacher_distill,
            **common)
        target_x1, _ = teacher.sample_intermediate(
            noise=x_mid, t_start=t_mid, t_end=t_dest,
            distill=teacher_distill, **common)

    loss_mask = draws["speech_condition_mask"] & ~make_pad_mask(
        features_lens, T)
    pred_x1, _ = student.sample_intermediate(
        noise=xt, t_start=t, t_end=t_dest, distill=True, **common,
        **(student_kw or {}))
    denom_t = t_dest - t
    pred_v = (pred_x1 - xt) / denom_t
    target_v = (target_x1 - xt) / denom_t
    m = loss_mask[:, :, None]
    # the global batch's count under a process group (parallel/mesh.py)
    d = torch.clamp(mesh.global_sum(loss_mask.sum()) * F, min=1)
    loss = torch.sum(torch.square(pred_v - target_v) * m) / d
    ref = torch.sum(torch.square(pred_v - (features - noise)) * m) / d
    return loss, ref


def make_distill_train_step(
    student_model: torch.nn.Module,
    teacher_model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    stage: str = "first",
    schedules: bool = True,
    max_duration: float = 250.0,
    ref_duration: float = 50.0,
    seed: int = 0,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Returns ``step(batch) -> {"loss", "ref_loss", "grad_norm"}`` (device
    scalars): one distillation loss, backward and ``optimizer.step()`` on
    the student.  ``teacher_model`` is the base ZipVoice for stage
    "first" (a CFG teacher) and the EMA copy of the student for stage
    "second", whose parameters the caller updates (``ema_update``).

    With ``schedules`` (on by default, as in the reference) the student
    runs in train mode with the schedule clock at adjusted_batch_count +
    100000, past the end of every ramp: dropout 0.1, module skips about 0,
    the regularizers' bounds at their final values (reference
    train_zipvoice_distill.py:564,589); without, in eval mode.  The
    teacher always runs in eval mode (:958).  ``step.step`` counts the
    steps taken and ``step.gens`` holds the generators, seeded from
    ``seed``."""
    assert stage in ("first", "second"), stage
    device = next(student_model.parameters()).device
    gens = TrainGenerators(seed, device)
    teacher_model.eval()

    def step(batch):
        gens.rows = mesh.batch_rows(batch["features"].shape[0])
        draws = draw_distill_inputs(gens, batch, stage)
        student_kw = {}
        if schedules:
            student_kw = dict(
                train=True, dropout_rate=None, gens=gens,
                batch_count=adjusted_batch_count(
                    step.step, max_duration=max_duration,
                    ref_duration=ref_duration, finetune=True),
            )
        optimizer.zero_grad(set_to_none=True)
        loss, ref = distill_losses(student_model, teacher_model, batch,
                                   draws, stage, student_kw)
        loss.backward()
        loss, ref = loss.detach(), ref.detach()
        # under a process group: the global gradient and losses, from one
        # all-reduce
        mesh.all_reduce_grads(student_model.parameters(), loss, ref)
        grads = [p.grad for p in student_model.parameters()
                 if p.grad is not None]
        grad_norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                   for g in grads))
        optimizer.step()
        step.step += 1
        return {"loss": loss, "ref_loss": ref, "grad_norm": grad_norm}

    step.step = 0
    step.gens = gens
    return step
