"""Euler ODE solver with classifier-free guidance (counterpart of
``zipvoice_tpu/models/solver.py``).  The JAX ``lax.scan`` over steps is a
Python loop; each step's velocity is taken in f32 before the update, as
JAX's type promotion does there.  Distillation training integrates over a
span whose bounds it draws on the device; those bounds are tensors here."""

from typing import Callable, Union

import numpy as np
import torch

from zipvoice_torch.utils import trace


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


def _t_vec(value, n: int, device) -> torch.Tensor:
    """A step's time (a number or a 0-dim tensor) as an f32 (n,) vector."""
    if torch.is_tensor(value):
        return value.reshape(1).expand(n)
    return torch.full((n,), float(value), dtype=torch.float32, device=device)


def cfg_inputs(text_condition: torch.Tensor, padding_mask: torch.Tensor):
    """The doubled batch's text condition (unconditional half zeroed) and
    padding mask that every CFG step of ``euler_step`` feeds the network."""
    return (torch.cat([torch.zeros_like(text_condition), text_condition],
                      dim=0),
            torch.cat([padding_mask, padding_mask], dim=0))


def euler_step(
    velocity_fn: VelocityFn,
    x: torch.Tensor,
    t,
    t_next,
    text_condition: torch.Tensor,
    speech_condition: torch.Tensor,
    padding_mask: torch.Tensor,
    guidance_scale: Union[float, torch.Tensor] = 0.0,
    distill: bool = False,
    cfg=None,
) -> torch.Tensor:
    """One step of ``euler_sample``: x (f32) at ``t_next`` from x at ``t``.
    ``t`` and ``t_next`` are numbers, or f32 0-dim tensors on the device
    (distillation's drawn bounds, an exported step program's inputs), and
    then the CFG rule's branch is a select.  ``cfg`` is ``cfg_inputs``'s
    pair when the caller made it once for every step."""
    B = x.shape[0]
    if distill:
        if torch.is_tensor(guidance_scale):
            gs_b = guidance_scale.float().reshape(-1).expand(B)
        else:
            gs_b = _t_vec(guidance_scale, B, x.device)
        v = velocity_fn(_t_vec(t, B, x.device), x, text_condition,
                        speech_condition, padding_mask, gs_b)
        return x + v.float() * (t_next - t)

    if not torch.is_tensor(guidance_scale) and guidance_scale == 0.0:
        v = velocity_fn(_t_vec(t, B, x.device), x, text_condition,
                        speech_condition, padding_mask, None)
        return x + v.float() * (t_next - t)

    if torch.is_tensor(guidance_scale):
        gs = guidance_scale.float()
        if gs.dim() > 0:
            gs = gs.reshape(-1, 1, 1)
    else:
        gs = float(guidance_scale)
    tc2, pm2 = cfg if cfg is not None else cfg_inputs(text_condition,
                                                      padding_mask)
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
        _t_vec(t, 2 * B, x.device), torch.cat([x, x], dim=0), tc2,
        torch.cat([uncond_speech, speech_condition], dim=0), pm2, None,
    ).float()
    v_uncond, v_cond = v2.chunk(2, dim=0)
    v = (1.0 + gs_eff) * v_cond - gs_eff * v_uncond
    return x + v * (t_next - t)


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
    distillation training), one ``euler_step`` a grid interval.

    - distill=True: the guidance scale is a network input, no doubling.
    - guidance_scale == 0 (a Python number): plain conditional steps.
    - otherwise CFG with batch doubling and the time-dependent rule: for
      t > 0.5 the unconditional half drops the speech condition, for
      t <= 0.5 it keeps it and the scale doubles.  A tensor scale (B, 1, 1)
      always takes this path, as in JAX.

    With tracing on, each step is a ``zv.step`` span (``utils/trace.py``),
    outside traced programs and graph captures only.
    """
    ts = _time_grid(t_start, t_end, num_step, t_shift, x.device)
    x = x.float()
    cfg = None
    if not distill and (torch.is_tensor(guidance_scale)
                        or guidance_scale != 0.0):
        cfg = cfg_inputs(text_condition, padding_mask)
    traced = trace.on and trace.steppable(x)
    for t, t_next in zip(ts[:-1], ts[1:]):
        if traced:
            step = trace.span("zv.step")
        x = euler_step(velocity_fn, x, t, t_next, text_condition,
                       speech_condition, padding_mask, guidance_scale,
                       distill, cfg)
        if traced:
            step.end()
    return x
