"""ScaledAdam and the Eden learning-rate schedule (counterpart of
``zipvoice_tpu/train/optim.py``).

ScaledAdam learns each tensor's direction with an Adam step scaled by the
tensor's RMS (refreshed every ``size_update_period`` steps) and its
log-scale from the accumulated sums of p * grad; momentum applies to the
combined step, with no beta1 bias correction.  Tensors of one element (the
BiasNorm ``log_scale``) take a plain Adam step at ``scalar_lr_scale`` of the
rate, clamped to +-``scalar_max``.  With ``clipping_scale`` the gradients are
clipped to that multiple of the median RMS-weighted gradient norm over the
last ``clipping_update_period`` steps.

The step counter lives on the host, so the period boundaries and the
learning rate are Python decisions; the norms' ring buffer, the clipping
threshold and the clipping factor stay on the device, and ``step()``
never waits on the device.  The per-tensor RMS, sums and element-wise rules
do not depend on a tensor's layout, so the port's (out, in) weights update
as the JAX package's (in, out) kernels do.
"""

import math
from typing import Callable, Iterable, Optional, Union

import numpy as np
import torch


def _f32_pow(base: float, exp: int) -> float:
    """base ** exp in f32, as the JAX package takes it for a traced step."""
    return float(np.float32(base) ** np.float32(exp))


def _grad(p: torch.Tensor) -> torch.Tensor:
    """p's gradient in f32; a tensor the loss did not reach has a zero
    gradient (its momentum and scale steps still run, as in JAX)."""
    return torch.zeros_like(p, dtype=torch.float32) if p.grad is None \
        else p.grad.float()


def _rms(p: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(p))).reshape((1,) * p.dim())


class ScaledAdam(torch.optim.Optimizer):
    def __init__(
        self,
        params: Iterable[torch.Tensor],
        lr: Union[float, Callable[[int], float]] = 0.045,
        clipping_scale: Optional[float] = None,
        betas=(0.9, 0.98),
        scalar_lr_scale: float = 0.1,
        eps: float = 1e-8,
        param_min_rms: float = 1e-5,
        param_max_rms: float = 3.0,
        scalar_max: float = 10.0,
        size_update_period: int = 4,
        clipping_update_period: int = 100,
    ):
        """``lr`` is a rate or a function of the step (``eden_schedule``)."""
        super().__init__(params, dict(lr=lr))
        self.lr = lr
        self.clipping_scale = clipping_scale
        self.betas = betas
        self.scalar_lr_scale = scalar_lr_scale
        self.eps = eps
        self.param_min_rms = param_min_rms
        self.param_max_rms = param_max_rms
        self.scalar_max = scalar_max
        self.size_update_period = size_update_period
        self.clipping_update_period = clipping_update_period
        self.step_count = 0
        self.model_norms = None
        self.model_norm_threshold = None

    def state_dict(self) -> dict:
        """``torch.optim.Optimizer``'s state (each tensor's moments, RMS
        and scale sums) plus the step counter and the clipping statistics,
        everything a resumed run needs to take the same steps."""
        sd = super().state_dict()
        for group in sd["param_groups"]:
            # the rate lives in ``self.lr`` (a schedule may be a closure,
            # which a checkpoint cannot hold)
            group.pop("lr", None)
        sd["scaled_adam"] = {
            "step_count": self.step_count,
            "model_norms": self.model_norms,
            "model_norm_threshold": self.model_norm_threshold,
        }
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        state_dict = dict(state_dict)
        extra = state_dict.pop("scaled_adam")
        super().load_state_dict(state_dict)
        dev = self._params()[0].device
        self.step_count = extra["step_count"]
        self.model_norms, self.model_norm_threshold = (
            None if t is None else t.to(dev)
            for t in (extra["model_norms"], extra["model_norm_threshold"]))

    def _params(self):
        return [p for group in self.param_groups for p in group["params"]]

    def _state(self, p: torch.Tensor) -> dict:
        st = self.state[p]
        if not st:
            f32 = dict(dtype=torch.float32, device=p.device)
            st["exp_avg_sq"] = torch.zeros(p.shape, **f32)
            st["delta"] = torch.zeros(p.shape, **f32)
            if p.numel() > 1:
                rms = _rms(p.detach().float())
                st["param_rms"] = rms
                st["scale_grads"] = torch.zeros(
                    (self.size_update_period,) + rms.shape, **f32
                )
                st["scale_exp_avg_sq"] = torch.zeros_like(rms)
        return st

    def _clip_factor(self, params, step):
        """The clipping factor, a device scalar (or 1.0 on step 0)."""
        period = self.clipping_update_period
        if self.model_norms is None:
            dev = params[0].device
            self.model_norms = torch.zeros(period, dtype=torch.float32,
                                           device=dev)
            self.model_norm_threshold = torch.full((), math.inf,
                                                   dtype=torch.float32,
                                                   device=dev)
        sumsq = []
        for p in params:
            g = _grad(p)
            st = self._state(p)
            if p.numel() == 1:
                sumsq.append(torch.sum(torch.square(g))
                             * self.scalar_lr_scale ** 2)
            else:
                sumsq.append(torch.sum(torch.square(g * st["param_rms"])))
        tot_norm = torch.sqrt(torch.stack(sumsq).sum())
        norms = self.model_norms
        norms[step % period] = tot_norm

        def median_of_last(k):
            # the last k recorded norms, sorted, at the reference's quartile
            # index; at the steps where this runs they are norms[1:k+1] (an
            # early estimate at step k) or all of them (a period boundary)
            vals = norms if k == period else norms[1: k + 1]
            return torch.sort(vals).values[min(k - 1, (k // 4) * 2)]

        for est_step in (10, 20, 40):
            if est_step < period and step == est_step:
                self.model_norm_threshold = (
                    self.clipping_scale * median_of_last(est_step) * 2.0
                )
        if step % period == 0 and step > 0:
            self.model_norm_threshold = (
                self.clipping_scale * median_of_last(period)
            )
        if step == 0:
            return 1.0
        clip = torch.clamp(self.model_norm_threshold / (tot_norm + 1e-20),
                           max=1.0)
        return torch.where(torch.isfinite(clip), clip, 0.0)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ScaledAdam.step takes no closure")
        step = self.step_count
        params = self._params()
        beta1, beta2 = self.betas
        cur_lr = self.lr(step) if callable(self.lr) else self.lr
        clip = (self._clip_factor(params, step)
                if self.clipping_scale is not None else 1.0)
        bias_correction2 = 1 - _f32_pow(beta2, step + 1)
        period = self.size_update_period
        period_end = step % period == period - 1
        beta2_corr = _f32_pow(beta2, period)
        size_step = (step + 1) // period
        scale_bias_c2 = 1 - _f32_pow(beta2_corr, max(size_step, 1))

        for p in params:
            st = self._state(p)
            p32 = p.float()
            g = _grad(p) * clip
            scalar = p.numel() == 1
            this_lr = cur_lr * (self.scalar_lr_scale if scalar else 1.0)

            exp_avg_sq = (beta2 * st["exp_avg_sq"]
                          + (1 - beta2) * torch.square(g))
            st["exp_avg_sq"] = exp_avg_sq
            corrected = (exp_avg_sq / bias_correction2
                         if bias_correction2 < 0.99 else exp_avg_sq)
            delta = -this_lr * g / (torch.sqrt(corrected) + self.eps)

            if scalar:
                new_delta = beta1 * st["delta"] + (1 - beta1) * delta
                st["delta"] = new_delta
                p.copy_(torch.clamp(p32 + new_delta, -self.scalar_max,
                                    self.scalar_max))
                continue

            st["scale_grads"][step % period] = torch.sum(p32 * g).reshape(
                st["param_rms"].shape
            )
            if period_end:
                st["param_rms"] = _rms(p32)
            param_rms = st["param_rms"]
            delta = delta * torch.clamp(param_rms, min=self.param_min_rms)
            if period_end:
                st["scale_exp_avg_sq"] = (
                    beta2_corr * st["scale_exp_avg_sq"]
                    + (1 - beta2_corr)
                    * torch.mean(torch.square(st["scale_grads"]), dim=0)
                )
                if step > 0:
                    size_lr = cur_lr * self.scalar_lr_scale
                    scale_denom = torch.sqrt(st["scale_exp_avg_sq"]) + self.eps
                    scale_step = (
                        -size_lr * math.sqrt(scale_bias_c2)
                        * torch.sum(st["scale_grads"], dim=0) / scale_denom
                    )
                    scale_step = torch.where(param_rms < self.param_min_rms,
                                             0.0, scale_step)
                    scale_step = torch.clamp(scale_step, -0.1, 0.1)
                    scale_step = torch.minimum(
                        scale_step,
                        (self.param_max_rms - param_rms) / param_rms,
                    )
                    delta = delta + p32 * scale_step
            new_delta = beta1 * st["delta"] + (1 - beta1) * delta
            st["delta"] = new_delta
            p.copy_(p32 + new_delta)

        self.step_count = step + 1


def eden_schedule(base_lr: float = 0.045, lr_batches: float = 7500.0,
                  lr_epochs: float = 10.0, warmup_batches: float = 500.0,
                  warmup_start: float = 0.5,
                  batches_per_epoch: Optional[float] = None
                  ) -> Callable[[int], float]:
    """Eden: base * ((b^2+B^2)/B^2)^-0.25 * ((e^2+E^2)/E^2)^-0.25 *
    warmup(b), the epoch factor taken from ``batches_per_epoch`` when given
    (else 1), as a function of the step b."""

    def schedule(step: int) -> float:
        b = float(step)
        factor = ((b ** 2 + lr_batches ** 2) / lr_batches ** 2) ** -0.25
        if batches_per_epoch is not None:
            e = b / batches_per_epoch
            factor *= ((e ** 2 + lr_epochs ** 2) / lr_epochs ** 2) ** -0.25
        warmup = (1.0 if b >= warmup_batches
                  else warmup_start + (1.0 - warmup_start)
                  * (b / warmup_batches))
        return base_lr * factor * warmup

    return schedule
