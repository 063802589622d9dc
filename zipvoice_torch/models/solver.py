"""Euler ODE solver with classifier-free guidance (counterpart of
``zipvoice_tpu/models/solver.py``).  The JAX ``lax.scan`` over steps is a
Python loop; each step's velocity is taken in f32 before the update, as
JAX's type promotion does there.  Distillation training integrates over a
span whose bounds it draws on the device; those bounds are tensors here."""

from typing import Callable, Union

import numpy as np
import torch


def get_time_steps(t_start: float = 0.0, t_end: float = 1.0,
                   num_step: int = 10, t_shift: float = 1.0) -> np.ndarray:
    """Shifted timestep grid: linspace warped by t <- s*t / (1 + (s-1)*t)."""
    ts = np.linspace(
        np.float32(t_start), np.float32(t_end), num_step + 1, dtype=np.float32
    )
    return np.float32(t_shift) * ts / (1 + (np.float32(t_shift) - 1) * ts)


# velocity_fn(t: (B,), x, text_condition, speech_condition, padding_mask,
#             guidance_scale: Optional[(B,)]) -> v
VelocityFn = Callable[..., torch.Tensor]


def _time_grid(t_start, t_end, num_step: int, t_shift: float, device):
    """The step grid: ``get_time_steps``'s numpy floats for Python bounds
    (inference), or an f32 tensor on ``device`` for tensor bounds drawn on
    the device (distillation), in the JAX package's arithmetic for traced
    bounds: linspace(0, 1) stretched over [t_start, t_end], then shifted."""
    if not (torch.is_tensor(t_start) or torch.is_tensor(t_end)):
        return get_time_steps(t_start, t_end, num_step, t_shift)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    frac = torch.linspace(0.0, 1.0, num_step + 1, dtype=torch.float32,
                          device=device)
    ts = f32(t_start) + (f32(t_end) - f32(t_start)) * frac
    s = f32(t_shift)
    return s * ts / (1 + (s - 1) * ts)


def euler_sample(
    velocity_fn: VelocityFn,
    x: torch.Tensor,
    text_condition: torch.Tensor,
    speech_condition: torch.Tensor,
    padding_mask: torch.Tensor,
    num_step: int,
    guidance_scale: Union[float, torch.Tensor] = 0.0,
    t_shift: float = 1.0,
    distill: bool = False,
    t_start: Union[float, torch.Tensor] = 0.0,
    t_end: Union[float, torch.Tensor] = 1.0,
) -> torch.Tensor:
    """Integrate the probability-flow ODE from ``t_start`` to ``t_end``
    (0 to 1 in inference; bounds drawn on the device, as tensors, in
    distillation training).

    - distill=True: the guidance scale is a network input, no doubling.
    - guidance_scale == 0 (a Python number): plain conditional steps.
    - otherwise CFG with batch doubling and the time-dependent rule: for
      t > 0.5 the unconditional half drops the speech condition, for
      t <= 0.5 it keeps it and the scale doubles.  A tensor scale (B, 1, 1)
      always takes this path, as in JAX.
    """
    B = x.shape[0]
    ts = _time_grid(t_start, t_end, num_step, t_shift, x.device)
    x = x.float()

    def t_vec(value, n):
        if torch.is_tensor(value):
            return value.reshape(1).expand(n)
        return torch.full((n,), float(value), dtype=torch.float32,
                          device=x.device)

    if distill:
        if torch.is_tensor(guidance_scale):
            gs_b = guidance_scale.float().reshape(-1).expand(B)
        else:
            gs_b = t_vec(guidance_scale, B)
        for t, t_next in zip(ts[:-1], ts[1:]):
            v = velocity_fn(t_vec(t, B), x, text_condition, speech_condition,
                            padding_mask, gs_b)
            x = x + v.float() * (t_next - t)
        return x

    if not torch.is_tensor(guidance_scale) and guidance_scale == 0.0:
        for t, t_next in zip(ts[:-1], ts[1:]):
            v = velocity_fn(t_vec(t, B), x, text_condition, speech_condition,
                            padding_mask, None)
            x = x + v.float() * (t_next - t)
        return x

    if torch.is_tensor(guidance_scale):
        gs = guidance_scale.float()
        if gs.dim() > 0:
            gs = gs.reshape(-1, 1, 1)
    else:
        gs = float(guidance_scale)
    pm2 = torch.cat([padding_mask, padding_mask], dim=0)
    tc2 = torch.cat([torch.zeros_like(text_condition), text_condition], dim=0)
    for t, t_next in zip(ts[:-1], ts[1:]):
        if torch.is_tensor(t):
            # a time on the device: the rule's branch as a select, so the
            # host never waits for it
            late = t > 0.5
            uncond_speech = torch.where(late, 0.0, speech_condition)
            gs_eff = torch.where(late, gs, gs * 2.0)
        elif t > 0.5:
            uncond_speech, gs_eff = torch.zeros_like(speech_condition), gs
        else:
            uncond_speech, gs_eff = speech_condition, gs * 2.0
        v2 = velocity_fn(
            t_vec(t, 2 * B), torch.cat([x, x], dim=0), tc2,
            torch.cat([uncond_speech, speech_condition], dim=0), pm2, None,
        ).float()
        v_uncond, v_cond = v2.chunk(2, dim=0)
        v = (1.0 + gs_eff) * v_cond - gs_eff * v_uncond
        x = x + v * (t_next - t)
    return x
