"""Numeric primitives of the Zipformer scaling toolkit (counterpart of
``zipvoice_tpu/ops/scaling.py``).

The forward-only activations and BiasNorm are plain functions.  The
training-only gradient-shaping transforms (``limit_param_value``,
``penalize_abs_values_gt``, ``balancer``, ``whiten``) are
``torch.autograd.Function``s whose forward is the identity and whose
backward is the JAX package's custom VJP.  Their bounds are Python floats
(the schedules resolve on the host), so no backward reads a bound from the
device.

Under a process group of more than one process (``parallel/mesh.py``) the
batch-wide statistics are those of the global batch, as under the JAX
package's sharding: the balancer's channel means and gradient RMS, the
whitening's covariance and norms, and the bypass limiter's gradient sign
are all-reduced in the backward.  A step's coins are equal on every
process, so every process reaches these collectives in the same order.
"""

import torch
import torch.nn.functional as F

from zipvoice_torch.parallel import mesh


def swoosh_l(x: torch.Tensor) -> torch.Tensor:
    """SwooshL activation: log(1 + exp(x-4)) - 0.08x - 0.035."""
    return F.softplus(x - 4.0) - 0.08 * x - 0.035


def swoosh_r(x: torch.Tensor) -> torch.Tensor:
    """SwooshR activation: log(1 + exp(x-1)) - 0.08x - 0.313261687."""
    return F.softplus(x - 1.0) - 0.08 * x - 0.313261687


def bias_norm(
    x: torch.Tensor, bias: torch.Tensor, log_scale: torch.Tensor
) -> torch.Tensor:
    """BiasNorm over the last axis:
    x * mean((x - bias)^2)^-0.5 * exp(log_scale)."""
    scales = torch.rsqrt(
        torch.mean(torch.square(x - bias), dim=-1, keepdim=True)
    )
    return x * (scales * torch.exp(log_scale))


class _LimitParamValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, min_val, max_val):
        ctx.save_for_backward(x)
        ctx.bounds = (min_val, max_val)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        min_val, max_val = ctx.bounds
        # the flips follow the sign of the global batch's gradient (with
        # one process, of ``g`` itself; a flip is exactly -1 or 1)
        total = mesh.global_sum(g)
        flip = torch.where((total > 0) & (x < min_val), -1.0, 1.0).to(g.dtype)
        total = total * flip
        flip = flip * torch.where((total < 0) & (x > max_val), -1.0,
                                  1.0).to(g.dtype)
        return g * flip, None, None


def limit_param_value(x: torch.Tensor, min_val: float,
                      max_val: float) -> torch.Tensor:
    """Identity forward; the backward flips the sign of a gradient that
    would push x further out of [min_val, max_val]."""
    return _LimitParamValue.apply(x, min_val, max_val)


class _PenalizeAbsValuesGt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, limit, penalty):
        ctx.save_for_backward(x)
        ctx.limit, ctx.penalty = limit, penalty
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        extra = ctx.penalty * torch.sign(x) * (x.abs() > ctx.limit).to(x.dtype)
        return g + extra, None, None


def penalize_abs_values_gt(x: torch.Tensor, limit: float,
                           penalty: float) -> torch.Tensor:
    """Identity forward; the backward adds the gradient of
    penalty * relu(|x| - limit).sum()."""
    return _PenalizeAbsValuesGt.apply(x, limit, penalty)


def _abs_to_rms(v: float) -> float:
    return 1.25331413732 * v


def _proportion_positive_to_mean(v: float) -> float:
    # crude inverse erf via atanh; the sums in double and the logs in f32,
    # as the JAX package evaluates it for a Python float
    eps = 1.0e-10
    t = -1.0 + 2.0 * v
    a = torch.log(torch.tensor(1 + t + eps, dtype=torch.float32))
    b = torch.log(torch.tensor(1 - t + eps, dtype=torch.float32))
    return float(0.8139535143 * ((a - b) / 2.0))


def _global_sums(sums, count=None):
    """The group's totals of the local ``sums`` (each differentiable in this
    process's input: the other processes' parts enter as constants) and of
    ``count``, from one all-reduce."""
    parts = [t.detach().reshape(-1) for t in sums]
    if count is not None:
        parts.append(torch.full((1,), float(count), dtype=parts[0].dtype,
                                device=parts[0].device))
    flat = mesh.all_reduce_(torch.cat(parts))
    out, offset = [], 0
    for t in sums:
        n = t.numel()
        out.append(flat[offset: offset + n].view_as(t) + (t - t.detach()))
        offset += n
    return out, (flat[-1] if count is not None else None)


def _batch_mean(x, dims):
    """``x``'s mean over ``dims`` (keepdim), over the global batch when
    ``mesh.reducing()``."""
    if not mesh.reducing():
        return torch.mean(x, dim=dims, keepdim=True)
    local = torch.sum(x, dim=dims, keepdim=True)
    (total,), count = _global_sums([local], x.numel() // local.numel())
    return total / count


def _balancer_stats(x, reduce_dims):
    if mesh.reducing():
        count = x.numel() // x.shape[-1]
        (s2, s1), n = _global_sums(
            [torch.sum(torch.square(x), dim=reduce_dims, keepdim=True),
             torch.sum(x, dim=reduce_dims, keepdim=True)], count)
        uncentered_var, mean = s2 / n, s1 / n
    else:
        uncentered_var = torch.mean(torch.square(x), dim=reduce_dims,
                                    keepdim=True)
        mean = torch.mean(x, dim=reduce_dims, keepdim=True)
    stddev = torch.sqrt(torch.clamp(uncentered_var - mean * mean, min=1.0e-20))
    rms = torch.sqrt(torch.clamp(uncentered_var, min=1.0e-20))
    return mean / stddev, rms


class _Balancer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, min_positive, max_positive, min_abs, max_abs,
                grad_scale):
        ctx.save_for_backward(x)
        ctx.args = (min_positive, max_positive, min_abs, max_abs, grad_scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        min_positive, max_positive, min_abs, max_abs, grad_scale = ctx.args
        min_mean = _proportion_positive_to_mean(min_positive)
        max_mean = _proportion_positive_to_mean(max_positive)
        min_rms, max_rms = _abs_to_rms(min_abs), _abs_to_rms(max_abs)
        reduce_dims = tuple(range(x.dim() - 1))  # channels are the last axis
        with torch.enable_grad():
            x32 = x.detach().float().requires_grad_(True)
            m, rms = _balancer_stats(x32, reduce_dims)
            m_loss = torch.abs(m - torch.clamp(m, min_mean, max_mean))
            r_loss = torch.abs(torch.log(
                torch.clamp(rms, min_rms, max_rms) / rms
            ))
            (loss_grad,) = torch.autograd.grad((m_loss + r_loss).sum(), x32)
        m, rms = m.detach(), rms.detach()
        # channels inside every bound contribute nothing: their analytic
        # gradient is zero, but float noise would survive the per-channel
        # normalization below
        violated = (m < min_mean) | (m > max_mean) | (rms < min_rms) \
            | (rms > max_rms)
        loss_grad = loss_grad * violated.float()
        loss_grad_rms = torch.clamp(
            torch.sqrt(_batch_mean(torch.square(loss_grad), reduce_dims)),
            min=1.0e-20,
        )
        loss_grad = loss_grad * (grad_scale / loss_grad_rms)
        g32 = g.float()
        out = (g32 + torch.abs(g32) * loss_grad).to(g.dtype)
        return out, None, None, None, None, None


def balancer(x: torch.Tensor, min_positive: float, max_positive: float,
             min_abs: float, max_abs: float,
             grad_scale: float) -> torch.Tensor:
    """Identity forward; the backward nudges each channel's (last axis)
    mean/rms statistics toward the given ranges."""
    return _Balancer.apply(x, min_positive, max_positive, min_abs, max_abs,
                           grad_scale)


def _whitening_metric(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """>= 1, and 1 exactly when each group's covariance is white.  Under
    ``mesh.reducing()`` the covariance is the global batch's: the frames
    are centred on the global mean, and the other processes' covariance
    enters as a constant (the mean's own gradient path sums to zero)."""
    x = x.reshape(-1, x.shape[-1])
    num_frames, num_channels = x.shape
    cpg = num_channels // num_groups
    x = x.reshape(num_frames, num_groups, cpg).transpose(0, 1)
    if mesh.reducing():
        (total,), count = _global_sums(
            [torch.sum(x.detach(), dim=1, keepdim=True)], num_frames)
        x = x - total / count
        (x_covar,), _ = _global_sums([torch.einsum("gtc,gtd->gcd", x, x)])
    else:
        x = x - torch.mean(x, dim=1, keepdim=True)
        x_covar = torch.einsum("gtc,gtd->gcd", x, x)
    diag = torch.diagonal(x_covar, dim1=1, dim2=2)
    x_covar_mean_diag = torch.mean(diag)
    x_covarsq_mean_diag = torch.sum(torch.square(x_covar)) / (
        num_groups * cpg
    )
    return x_covarsq_mean_diag / (torch.square(x_covar_mean_diag) + 1.0e-20)


class _Whiten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, num_groups, whitening_limit, grad_scale):
        ctx.save_for_backward(x)
        ctx.args = (num_groups, whitening_limit, grad_scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        num_groups, whitening_limit, grad_scale = ctx.args
        with torch.enable_grad():
            x32 = x.detach().float().requires_grad_(True)
            metric = _whitening_metric(x32, num_groups)
            (penalty_grad,) = torch.autograd.grad(metric, x32)
        g32 = g.float()
        if mesh.reducing():
            # the global batch's norms, from one all-reduce
            g_norm, p_norm = torch.sqrt(mesh.global_sum(torch.stack(
                [torch.sum(torch.square(g32)),
                 torch.sum(torch.square(penalty_grad))])))
        else:
            g_norm = torch.linalg.vector_norm(g32)
            p_norm = torch.linalg.vector_norm(penalty_grad)
        scale = grad_scale * (g_norm / (p_norm + 1.0e-20))
        # a device-side select: no sync on the metric
        out = torch.where(metric.detach() < whitening_limit, g32,
                          g32 + penalty_grad * scale)
        return out.to(g.dtype), None, None, None


def whiten(x: torch.Tensor, num_groups: int, whitening_limit: float,
           grad_scale: float) -> torch.Tensor:
    """Identity forward; the backward adds a scaled gradient of the
    whitening metric when the metric exceeds ``whitening_limit``."""
    return _Whiten.apply(x, num_groups, whitening_limit, grad_scale)
