"""TTS Zipformer backbone in PyTorch, for inference and training.

Counterpart of ``zipvoice_tpu/models/zipformer.py``: batch-major (B, T, C)
layout, padding carried by boolean masks (True = padded), and module and
parameter names that follow the reference torch ``state_dict`` (the keys
``zipvoice_tpu/utils/convert.py`` translates), so a published ``model.pt``
loads with ``strict=True``.

Every module's ``forward`` takes ``train``, ``batch_count``, ``gens`` (and,
where the JAX module has it, ``dropout_rate``) as the JAX modules do.  With
``train=True`` the training-only regularizers run: balancers, whitening,
the score penalty, scheduled sequence skips, layer bypass, const-attention,
the pos-emb skip and dropout.  Their scalar coins are drawn on the host
from ``gens.host`` and the branch is taken in Python; their masks are drawn
on the device from ``gens.device`` (``TrainGenerators``).  ``_stochastic``
and ``_rand_uniform`` are the only entry points of that randomness, so a
test can pin them as it pins the JAX package's functions of the same names.
A mask with one value a sequence is drawn at the global batch and sliced to
this process's rows (``_rand_rows``, ``TrainGenerators.rows``), so the
processes of a group draw what one process would.

Mixed precision mirrors the JAX package: the matmul and convolution weights
run in a compute dtype while norms, bypass scales and downsampling weights
stay f32, and PyTorch's type promotion then follows JAX's (a bf16
activation meeting an f32 per-channel parameter becomes f32).  Inference
casts those weights once (``set_compute_dtype``); training keeps them f32
and casts at use (``set_compute_dtype(..., cast_weights=False)``), as
flax's ``Dense(param_dtype=f32, dtype=bf16)`` does.
"""

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from zipvoice_torch.kernels.depthwise_conv import (
    depthwise_conv1d,
    depthwise_conv1d_trainable,
)
from zipvoice_torch.kernels.rel_pos_attention import (
    SCORE_LIMIT,
    SCORE_PENALTY,
    attention_apply,
    rel_pos_attention_weights,
    rel_pos_attention_weights_nonlin,
    rel_pos_attention_weights_trainable,
)
from zipvoice_torch.ops import schedule as sched
from zipvoice_torch.ops.scaling import (
    balancer,
    bias_norm,
    limit_param_value,
    penalize_abs_values_gt,
    swoosh_l,
    swoosh_r,
    whiten,
)
from zipvoice_torch.parallel import mesh

# Shortest sequence that takes the attention-weights kernels (inference and
# the training pair).  640 is the JAX package's TPU threshold
# (zipvoice_tpu/ops/pallas_attention.py:50); it is a provisional default
# here, not yet measured on the H100.  The fused weights + NonlinAttention
# kernel takes the same gate.
MIN_SEQ_LEN = 640
# Shortest sequence whose SelfAttention takes the application kernel, when it
# is switched on.  640 is the JAX package's TPU value
# (zipvoice_tpu/ops/pallas_attention.py:72); provisional as MIN_SEQ_LEN is.
MIN_APPLY_SEQ_LEN = 640


class TrainGenerators:
    """The random sources of a training forward: ``host``, a CPU generator,
    draws every scalar coin (so no branch waits on the device), and
    ``device`` draws the per-sequence and per-channel masks and the step's
    noise where the activations live."""

    def __init__(self, seed: int, device="cpu"):
        self.host = torch.Generator().manual_seed(seed)
        self.device = torch.Generator(device=device).manual_seed(seed + 1)
        # (global batch, this process's row slice) while the draws are a
        # slice of a global batch's (``parallel.mesh.batch_rows``), or None
        self.rows = None

    def batch_rows(self, batch_size: int):
        """(the batch size to draw at, the rows to keep) for a batch of
        ``batch_size`` rows on this process."""
        if self.rows is None:
            return batch_size, slice(None)
        total, rows = self.rows
        if rows.stop - rows.start != batch_size:
            raise ValueError(f"a batch of {batch_size} rows, but this "
                             f"process holds rows {rows} of {total}")
        return total, rows


def _stochastic(gens: TrainGenerators, prob: float, fn, x):
    """Apply a backward-only (identity-forward) regularizer with
    probability ``prob``, on a coin drawn on the host."""
    if torch.rand((), generator=gens.host).item() < prob:
        return fn(x)
    return x


def _rand_uniform(gens: TrainGenerators, shape, device=None):
    """U[0, 1) draws of the schedule-driven randomness: a Python float from
    the host generator for a scalar coin (shape ()), else a tensor on
    ``device`` from the device generator."""
    if tuple(shape) == ():
        return torch.rand((), generator=gens.host).item()
    return torch.rand(shape, generator=gens.device, device=device)


def _rand_rows(gens: TrainGenerators, shape, device=None):
    """``_rand_uniform`` of a batch-leading ``shape``, drawn at the global
    batch and sliced to this process's rows (``gens.rows``)."""
    if gens.rows is None:
        return _rand_uniform(gens, shape, device)
    total, rows = gens.batch_rows(shape[0])
    return _rand_uniform(gens, (total, *shape[1:]), device)[rows]


def _seq_skip_mask(gens, batch_size, rate, dtype, device):
    """Per-sequence keep mask (B, 1, 1): 0 drops a submodule's contribution
    for that sequence (no 1/(1-p) rescale)."""
    u = _rand_rows(gens, (batch_size, 1, 1), device)
    return (u > rate).to(dtype)


def _shared_dropout(gens, x, rate):
    """Dropout with the mask shared along time (axis 1) and the 1/(1-p)
    rescale."""
    B, _, C = x.shape
    keep = (_rand_rows(gens, (B, 1, C), x.device) >= rate).to(x.dtype)
    return x * keep / (1.0 - rate)


# the keyword arguments an inference forward passes to its submodules
_NO_TRAIN = {}


def _skip(gens, x, rate):
    """Scheduled sequence-level dropout of a submodule's contribution."""
    return x * _seq_skip_mask(gens, x.shape[0], rate, x.dtype, x.device)


def _balance(gens, x, prob, *bounds):
    return _stochastic(gens, prob, lambda t: balancer(t, *bounds), x)


def _static_zero(v) -> bool:
    """A literal 0 dropout rate: the caller's switch that turns dropout off
    (a scheduled rate is a float that never reaches 0)."""
    return isinstance(v, (int, float)) and float(v) == 0.0


class Linear(nn.Linear):
    """``nn.Linear`` that runs in its weight's dtype, or casts weight, bias
    and input to ``compute_dtype`` at use when that is set (training), with
    the JAX package's init: U(+-scale/sqrt(in)) weights and, for a
    ScaledLinear (scale != 1), U(+-0.1*scale) biases."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, initial_scale: float = 1.0):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = None
        with torch.no_grad():
            bound = initial_scale / math.sqrt(in_features)
            self.weight.uniform_(-bound, bound)
            if bias:
                b = (1.0 / math.sqrt(in_features) if initial_scale == 1.0
                     else 0.1 * initial_scale)
                self.bias.uniform_(-b, b)

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return F.linear(x.to(self.weight.dtype), self.weight, self.bias)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def set_attention_kernel(module: nn.Module, enabled: bool,
                         fuse_nonlin: bool = False,
                         apply: bool = False) -> nn.Module:
    """Switch the attention kernels under ``module``: the weights kernels
    of every RelPosAttentionWeights (on by default; off, every level takes
    the plain skew path) and, with them, two inference-only kernels that
    are off by default as in the JAX package: ``fuse_nonlin`` computes the
    weights and NonlinAttention's application of head 0's weights in one
    kernel (its ``FUSE_NONLIN``), ``apply`` runs SelfAttention's weights @
    values in a kernel (its ``APPLY_KERNEL``)."""
    for m in module.modules():
        if isinstance(m, RelPosAttentionWeights):
            m.use_kernel = enabled
        elif isinstance(m, ZipformerEncoderLayer):
            m.fuse_nonlin = enabled and fuse_nonlin
        elif isinstance(m, SelfAttention):
            m.use_kernel = enabled and apply
    return module


def set_conv_kernel(module: nn.Module, enabled: bool) -> nn.Module:
    """Switch the depthwise-conv kernels on or off in every
    ConvolutionModule under ``module`` (off by default, as the JAX
    package's ``use_pallas_conv``): the forward kernel in inference, the
    forward and backward pair where gradients are recorded."""
    for m in module.modules():
        if isinstance(m, ConvolutionModule):
            m.use_kernel = enabled
    return module


def set_kernel_config(module: nn.Module, enabled: bool = True) -> nn.Module:
    """Put ``module`` in the kernel configuration (every kernel switch on:
    the JAX package with ``use_pallas_attention=True``,
    ``use_pallas_conv=True``, ``ZIPVOICE_PALLAS_FUSE_NONLIN=1`` and
    ``ZIPVOICE_PALLAS_APPLY=1``), or back to the default configuration
    (only the attention-weights kernels on)."""
    set_attention_kernel(module, True, fuse_nonlin=enabled, apply=enabled)
    return set_conv_kernel(module, enabled)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype,
                      cast_weights: bool = True) -> nn.Module:
    """Run the Linear and Conv1d layers under ``module`` in ``dtype`` (the
    JAX modules' ``dtype``); every other parameter stays f32.  With
    ``cast_weights`` (inference) the weights are cast once; without it
    (training) they stay f32 master weights and are cast at each use."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            if cast_weights:
                m.to(dtype)
            else:
                m.compute_dtype = dtype
    return module


class SwooshR(nn.Module):
    def forward(self, x):
        return swoosh_r(x)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding, (B,) -> (B, dim), laid out as
    [cos(all freqs), sin(all freqs)], max period 10000."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(10000.0)
        * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb


def compact_rel_pos_encoding(seq_len: int, pos_dim: int,
                             device=None) -> torch.Tensor:
    """Compact relative positional table, (2T-1, pos_dim); row n encodes
    offset n - (T-1): a log-compressed, atan-warped Fourier basis with the
    last channel pinned to 1."""
    T = seq_len
    x = torch.arange(-(T - 1), T, dtype=torch.float32, device=device)[:, None]
    freqs = 1.0 + torch.arange(pos_dim // 2, dtype=torch.float32,
                               device=device)
    compression_length = pos_dim ** 0.5
    x_compressed = (
        compression_length * torch.sign(x)
        * (torch.log(torch.abs(x) + compression_length)
           - math.log(compression_length))
    )
    length_scale = pos_dim / (2.0 * math.pi)
    x_atan = torch.atan(x_compressed / length_scale)
    pe = torch.stack(
        [torch.cos(x_atan * freqs), torch.sin(x_atan * freqs)], dim=-1
    ).reshape(2 * T - 1, pos_dim)
    pe[:, -1] = 1.0
    return pe


class BiasNorm(nn.Module):
    def __init__(self, num_channels: int):
        super().__init__()
        self.log_scale = nn.Parameter(torch.tensor(1.0))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        return bias_norm(x, self.bias, self.log_scale)


class BypassModule(nn.Module):
    """Learnable per-channel interpolation between a block's input and
    output.  In training with a batch count the scale is held in the
    scheduled [scale_min, 1] window (``limit_param_value``) and, with a
    ``skip_rate`` schedule (the layer's layerdrop ramp), whole sequences
    skip the block."""

    def __init__(self, embed_dim: int,
                 skip_rate: Optional[sched.ScheduledFloat] = None):
        super().__init__()
        self.skip_rate = skip_rate
        self.bypass_scale = nn.Parameter(torch.full((embed_dim,), 0.5))

    def forward(self, src_orig, src, train: bool = False, batch_count=None,
                gens: Optional[TrainGenerators] = None):
        scale = self.bypass_scale
        if train and batch_count is not None:
            scale = limit_param_value(
                scale, sched.BYPASS_SCALE_MIN(batch_count), 1.0
            )
            if self.skip_rate is not None:
                scale = scale * _seq_skip_mask(
                    gens, src.shape[0], self.skip_rate(batch_count),
                    scale.dtype, src.device,
                )
        return src_orig + (src - src_orig) * scale


class RelPosAttentionWeights(nn.Module):
    """Relative-position attention weights, (B, num_heads, T, T).

    Sequences with ``T >= MIN_SEQ_LEN`` go through the CUDA kernels
    (``kernels/rel_pos_attention.py``: the inference kernel, or in training
    the differentiable forward/backward pair) while ``use_kernel`` is set
    (see ``set_attention_kernel``); shorter ones, or all with the kernels
    off, take the plain skew path below.  The 1/sqrt(d) scaling is baked
    into in_proj's initial scale.
    """

    def __init__(self, embed_dim: int, pos_dim: int, num_heads: int,
                 query_head_dim: int, pos_head_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.query_head_dim = query_head_dim
        self.pos_head_dim = pos_head_dim
        self.use_kernel = True
        self.in_proj = Linear(
            embed_dim, (2 * query_head_dim + pos_head_dim) * num_heads,
            initial_scale=query_head_dim ** -0.25,
        )
        self.linear_pos = Linear(pos_dim, num_heads * pos_head_dim,
                                 bias=False, initial_scale=0.05)

    def forward(self, x, pos_emb, key_padding_mask=None, train: bool = False,
                batch_count=None, gens: Optional[TrainGenerators] = None,
                return_projections: bool = False):
        """The weights, or with ``return_projections`` (inference only) the
        kernels' inputs (q, k, p (B, h, T, d), pe (h, 2T-1, pd), key mask
        (B, T)) for the layer's fused path to compute them."""
        h, qd, pd = self.num_heads, self.query_head_dim, self.pos_head_dim
        B, T, _ = x.shape
        proj = self.in_proj(x)
        q = proj[..., : h * qd].reshape(B, T, h, qd)
        k = proj[..., h * qd: 2 * h * qd].reshape(B, T, h, qd)
        if train:
            k = _stochastic(
                gens, 0.025,
                lambda t: balancer(t, 0.4, 0.6, 0.0, 100.0, 0.04), k,
            )
            k = _stochastic(
                gens, 0.15,
                lambda t: whiten(t, h, sched.WHITEN_KEYS(batch_count), 0.025),
                k,
            )
        p = proj[..., 2 * h * qd:].reshape(B, T, h, pd)
        pe = self.linear_pos(pos_emb).reshape(2 * T - 1, h, pd)
        # scheduled pos-emb skip: the positional term is dropped for this
        # whole call (it is linear in p, so zeroing p zeroes it)
        use_pos = True
        if train and batch_count is not None:
            use_pos = (_rand_uniform(gens, ())
                       >= sched.POS_EMB_SKIP(batch_count))

        if return_projections or (self.use_kernel and T >= MIN_SEQ_LEN):
            if key_padding_mask is None:
                key_padding_mask = torch.zeros(
                    (B, T), dtype=torch.bool, device=x.device
                )
            if not use_pos:
                p = p * 0.0
            args = (
                q.transpose(1, 2).contiguous(),
                k.transpose(1, 2).contiguous(),
                p.transpose(1, 2).contiguous(),
                pe.transpose(0, 1).contiguous(),
                key_padding_mask.contiguous(),
            )
            if return_projections:
                if train:
                    raise ValueError("the fused path is inference only")
                return args
            if not train:
                return rel_pos_attention_weights(*args)
            # the coin the plain path's score penalty draws; the backward
            # applies the penalty only where the forward saw |score| > 25
            coin = _stochastic(gens, 0.1, lambda _: True, False)
            return rel_pos_attention_weights_trainable(*args, coin)

        attn_scores = torch.einsum("bthd,bshd->bhts", q, k)
        pos_scores = torch.einsum("bthd,nhd->bhtn", p, pe)
        # abs_score[i, j] = rel_score[i, j - i + T - 1], gather-free: pad one
        # column, flatten, shift by T-1 and restride, so element (i, j) reads
        # flat index (T-1) + i*(2T-1) + j.
        flat = F.pad(pos_scores, (0, 1)).reshape(B, h, 2 * T * T)
        flat = flat[..., T - 1: T - 1 + T * (2 * T - 1)]
        pos_scores = flat.reshape(B, h, T, 2 * T - 1)[..., :T]
        if not use_pos:
            pos_scores = pos_scores * 0.0
        attn_scores = attn_scores + pos_scores
        if train:
            attn_scores = _stochastic(
                gens, 0.1,
                lambda t: penalize_abs_values_gt(t, SCORE_LIMIT,
                                                 SCORE_PENALTY),
                attn_scores,
            )
        if key_padding_mask is not None:
            # -1000 (not -inf) so that fully masked rows stay finite
            attn_scores = attn_scores.masked_fill(
                key_padding_mask[:, None, None, :], -1000.0
            )
        if not train and attn_scores.dtype == torch.bfloat16:
            # keep the T^2 exp intermediate in bf16 and the normalizer in f32
            m = torch.amax(attn_scores, dim=-1, keepdim=True)
            e = torch.exp(attn_scores - m)
            s = torch.sum(e, dim=-1, keepdim=True, dtype=torch.float32)
            return (e.float() / s).to(attn_scores.dtype)
        return torch.softmax(attn_scores.float(), dim=-1).to(attn_scores.dtype)


class SelfAttention(nn.Module):
    """Applies precomputed attention weights to projected values.  The
    weights' first ``skip_heads`` heads are not its own (under tensor
    parallelism, ``parallel/sharding_rules.py``, a rank that lacks head 0
    computes it first for NonlinAttention)."""

    def __init__(self, embed_dim: int, num_heads: int, value_head_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.value_head_dim = value_head_dim
        self.skip_heads = 0
        # the application kernel, in inference at T >= MIN_APPLY_SEQ_LEN
        # (set_attention_kernel(..., apply=True))
        self.use_kernel = False
        self.in_proj = Linear(embed_dim, num_heads * value_head_dim)
        self.out_proj = Linear(num_heads * value_head_dim, embed_dim,
                               initial_scale=0.05)

    def forward(self, x, attn_weights, train: bool = False, batch_count=None,
                gens: Optional[TrainGenerators] = None):
        B, T, _ = x.shape
        h, vd = self.num_heads, self.value_head_dim
        v = self.in_proj(x).reshape(B, T, h, vd).transpose(1, 2)
        if self.skip_heads:
            attn_weights = attn_weights[:, self.skip_heads:]
        if self.use_kernel and not train and T >= MIN_APPLY_SEQ_LEN:
            out = attention_apply(attn_weights, v.contiguous())
        else:
            out = torch.matmul(attn_weights, v)
        out = self.out_proj(out.transpose(1, 2).reshape(B, T, h * vd))
        if train:
            out = _stochastic(
                gens, 0.15,
                lambda v: whiten(v, 1, sched.WHITEN_SELF_ATTN(batch_count),
                                 0.01),
                out,
            )
        return out


class NonlinAttention(nn.Module):
    """Tanh-gated values mixed by head 0's attention weights."""

    def __init__(self, channels: int, hidden_channels: int):
        super().__init__()
        self.in_proj = Linear(channels, hidden_channels * 3)
        self.out_proj = Linear(hidden_channels, channels, initial_scale=0.05)

    def forward(self, x, attn_weights_head0, train: bool = False,
                batch_count=None, gens: Optional[TrainGenerators] = None,
                apply_fn=None):
        """``attn_weights_head0`` (B, T, T), or None with ``apply_fn`` set:
        then ``apply_fn(v)`` applies the weights to the gated values (the
        layer's fused path, which computes the weights and this product in
        one kernel)."""
        s, v, y = self.in_proj(x).chunk(3, dim=-1)
        bc = batch_count
        if train:
            s = _stochastic(
                gens, sched.BALANCER_PROB(bc),
                lambda t: balancer(
                    t, sched.NONLIN_MIN_POSITIVE(bc),
                    sched.NONLIN_MAX_POSITIVE(bc), 0.5, 5.0, 0.04,
                ),
                s,
            )
        v = v * torch.tanh(s)
        if train:
            v = _stochastic(
                gens, 0.15,
                lambda t: whiten(t, 1, sched.WHITEN_NONLIN(bc), 0.01), v,
            )
        if apply_fn is not None:
            v = apply_fn(v)
        else:
            v = torch.matmul(attn_weights_head0, v)
        v = self.out_proj(v * y)
        if train:
            v = _stochastic(
                gens, 0.15,
                lambda t: whiten(t, 1, sched.WHITEN_NONLIN2(bc), 0.01), v,
            )
        return v


class FeedforwardModule(nn.Module):
    def __init__(self, embed_dim: int, feedforward_dim: int):
        super().__init__()
        self.in_proj = Linear(embed_dim, feedforward_dim)
        self.out_proj = Linear(feedforward_dim, embed_dim, initial_scale=0.1)

    def forward(self, x, train: bool = False, dropout_rate=0.0,
                batch_count=None, gens: Optional[TrainGenerators] = None):
        x = self.in_proj(x)
        if train:
            x = _stochastic(
                gens, sched.BALANCER_PROB(batch_count),
                lambda v: balancer(v, 0.3, 1.0, 0.75, 5.0, 0.04), x,
            )
        x = swoosh_l(x)
        if train and not _static_zero(dropout_rate):
            x = _shared_dropout(gens, x, dropout_rate)
        x = self.out_proj(x)
        if train:
            x = _stochastic(
                gens, 0.15,
                lambda v: whiten(v, 1, sched.WHITEN_FF(batch_count), 0.01),
                x,
            )
        return x


class ConvolutionModule(nn.Module):
    """Sigmoid-GLU -> depthwise conv1d over time -> SwooshR -> Linear.  With
    ``use_kernel`` (``set_conv_kernel``) the conv runs in the CUDA kernel
    (``kernels/depthwise_conv.py``), and where gradients are recorded in
    its forward/backward pair."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.use_kernel = False
        self.in_proj = Linear(channels, 2 * channels)
        self.depthwise_conv = nn.Conv1d(
            channels, channels, kernel_size, padding=kernel_size // 2,
            groups=channels,
        )
        self.depthwise_conv.compute_dtype = None
        self.out_proj = Linear(channels, channels, initial_scale=0.05)

    def forward(self, x, key_padding_mask=None, train: bool = False,
                batch_count=None, gens: Optional[TrainGenerators] = None):
        bc = batch_count
        v, s = self.in_proj(x).chunk(2, dim=-1)
        if train:
            s = _stochastic(
                gens, sched.BALANCER_PROB(bc),
                lambda t: balancer(
                    t, sched.CONV_B1_MIN_POSITIVE(bc), 1.0, 1.5,
                    sched.CONV_B1_MAX_ABS(bc), 0.04,
                ),
                s,
            )
        v = v * torch.sigmoid(s)
        if key_padding_mask is not None:
            v = v.masked_fill(key_padding_mask[:, :, None], 0.0)
        conv = self.depthwise_conv
        w, b = conv.weight, conv.bias
        if conv.compute_dtype is not None:
            w, b = w.to(conv.compute_dtype), b.to(conv.compute_dtype)
        if self.use_kernel:
            conv_fn = (depthwise_conv1d_trainable if torch.is_grad_enabled()
                       else depthwise_conv1d)
            v = conv_fn(v.to(w.dtype).contiguous(),
                        w.view(w.shape[0], w.shape[2]), b)
        else:
            v = F.conv1d(
                v.transpose(1, 2).to(w.dtype), w, b,
                padding=conv.padding, groups=conv.groups,
            ).transpose(1, 2)
        if train:
            v = _stochastic(
                gens, sched.BALANCER_PROB(bc),
                lambda t: balancer(
                    t, sched.CONV_B2_MIN_POSITIVE(bc), 1.0,
                    sched.CONV_B2_MIN_ABS(bc), 10.0, 0.04,
                ),
                v,
            )
            v = _stochastic(
                gens, 0.15,
                lambda t: whiten(t, 1, sched.WHITEN_CONV(bc), 0.01), v,
            )
        return self.out_proj(swoosh_r(v))


class ZipformerEncoderLayer(nn.Module):
    """One Zipformer2 layer; ``bypass_skip_rate`` is the layer's layerdrop
    ramp (set by ZipformerEncoder)."""

    def __init__(self, embed_dim: int, pos_dim: int, num_heads: int,
                 query_head_dim: int, pos_head_dim: int, value_head_dim: int,
                 feedforward_dim: int, cnn_module_kernel: int,
                 bypass_skip_rate: Optional[sched.ScheduledFloat] = None):
        super().__init__()
        d = embed_dim
        # inference: the weights and NonlinAttention's application of head
        # 0's weights in one kernel at T >= MIN_SEQ_LEN
        # (set_attention_kernel(..., fuse_nonlin=True))
        self.fuse_nonlin = False
        self.self_attn_weights = RelPosAttentionWeights(
            d, pos_dim, num_heads, query_head_dim, pos_head_dim
        )
        self.feed_forward1 = FeedforwardModule(d, (feedforward_dim * 3) // 4)
        self.nonlin_attention = NonlinAttention(d, 3 * d // 4)
        self.self_attn1 = SelfAttention(d, num_heads, value_head_dim)
        self.conv_module1 = ConvolutionModule(d, cnn_module_kernel)
        self.feed_forward2 = FeedforwardModule(d, feedforward_dim)
        self.bypass_mid = BypassModule(d)
        self.self_attn2 = SelfAttention(d, num_heads, value_head_dim)
        self.conv_module2 = ConvolutionModule(d, cnn_module_kernel)
        self.feed_forward3 = FeedforwardModule(d, (feedforward_dim * 5) // 4)
        self.norm = BiasNorm(d)
        self.bypass = BypassModule(d, skip_rate=bypass_skip_rate)

    def forward(self, src, pos_emb, time_emb=None, key_padding_mask=None,
                train: bool = False, dropout_rate=0.0, batch_count=None,
                gens: Optional[TrainGenerators] = None):
        src_orig = src
        B = src.shape[0]
        # inference passes no training arguments down and builds nothing
        # for them per call
        kw = (dict(train=True, batch_count=batch_count, gens=gens)
              if train else _NO_TRAIN)
        scheds_on = train and batch_count is not None
        bc = batch_count if train else None

        # the fused path defers the weights until NonlinAttention's gated
        # values exist, so that one kernel computes both
        fused = (not train and self.fuse_nonlin
                 and src.shape[1] >= MIN_SEQ_LEN)
        if fused:
            projections = self.self_attn_weights(
                src, pos_emb, key_padding_mask, return_projections=True
            )
            attn_weights = None
        else:
            attn_weights = self.self_attn_weights(src, pos_emb,
                                                  key_padding_mask, **kw)
        if time_emb is not None:
            src = src + time_emb
        src = src + self.feed_forward1(src, dropout_rate=dropout_rate, **kw)

        # one sequence-level skip mask shared by nonlin-attention and both
        # self-attention applications
        attn_skip_mask = None
        if scheds_on:
            attn_skip_mask = _seq_skip_mask(
                gens, B, sched.ATTENTION_SKIP(batch_count), src.dtype,
                src.device,
            )
        if fused:
            weights = []

            def apply_head0(nv):
                w, na = rel_pos_attention_weights_nonlin(*projections,
                                                         nv.contiguous())
                weights.append(w)
                return na

            na = self.nonlin_attention(src, None, apply_fn=apply_head0)
            (attn_weights,) = weights
        else:
            # head-0 weights for NonlinAttention; under the scheduled
            # const-attention coin, a uniform average over the kept
            # positions
            sel_weights = attn_weights[:, 0]
            if scheds_on and (_rand_uniform(gens, ())
                              < sched.CONST_ATTENTION(batch_count)):
                nonzero = (sel_weights > 0.0).to(sel_weights.dtype)
                sel_weights = nonzero / nonzero.sum(dim=-1, keepdim=True)
            na = self.nonlin_attention(src, sel_weights, **kw)
        if train:
            na = _balance(gens, na, 0.05, 0.3, 0.7,
                          sched.BALANCER_NA_MIN_ABS(bc), 100.0, 0.04)
        if attn_skip_mask is not None:
            na = na * attn_skip_mask
        src = src + na

        self_attn = self.self_attn1(src, attn_weights, **kw)
        if attn_skip_mask is not None:
            self_attn = self_attn * attn_skip_mask
        src = src + self_attn

        if time_emb is not None:
            src = src + time_emb
        conv = self.conv_module1(src, key_padding_mask, **kw)
        if scheds_on:
            conv = _skip(gens, conv, sched.CONV_SKIP(bc))
        src = src + conv

        ff2 = self.feed_forward2(src, dropout_rate=dropout_rate, **kw)
        if train:
            ff2 = _balance(gens, ff2, 0.05, 0.3, 0.7,
                           sched.BALANCER_FF2_MIN_ABS(bc), 2.0, 0.04)
        if scheds_on:
            ff2 = _skip(gens, ff2, sched.FF2_SKIP(bc))
        src = src + ff2

        src = self.bypass_mid(src_orig, src, **kw)

        self_attn = self.self_attn2(src, attn_weights, **kw)
        if attn_skip_mask is not None:
            self_attn = self_attn * attn_skip_mask
        src = src + self_attn

        if time_emb is not None:
            src = src + time_emb
        conv = self.conv_module2(src, key_padding_mask, **kw)
        if scheds_on:
            conv = _skip(gens, conv, sched.CONV_SKIP(bc))
        src = src + conv

        ff3 = self.feed_forward3(src, dropout_rate=dropout_rate, **kw)
        if train:
            ff3 = _balance(gens, ff3, 0.05, 0.3, 0.7,
                           sched.BALANCER_FF3_MIN_ABS(bc), 4.0, 0.04)
        if scheds_on:
            ff3 = _skip(gens, ff3, sched.FF3_SKIP(bc))
        src = src + ff3

        if train:
            src = _balance(gens, src, sched.BALANCER_PROB(bc), 0.45, 0.55,
                           0.2, 4.0, 0.04)
        src = self.norm(src)
        src = self.bypass(src_orig, src, **kw)
        if train:
            src = _balance(gens, src, sched.BALANCER_PROB(bc), 0.45, 0.55,
                           0.1, 4.0, 0.04)
            src = _stochastic(
                gens, 0.15,
                lambda t: whiten(t, 1, sched.WHITEN_LAYER(bc), 0.01), src,
            )
        return src


class ZipformerEncoder(nn.Module):
    """A stack of layers sharing one positional table; ``time_embed_dim``
    of -1 means no time embedding.  Layer i's bypass skips whole sequences
    at a rate that ramps from 0.5 to ``final_layerdrop_rate`` over its own
    share of [warmup_begin, warmup_end] batches."""

    def __init__(self, num_layers: int, embed_dim: int, time_embed_dim: int,
                 pos_dim: int, num_heads: int, query_head_dim: int,
                 pos_head_dim: int, value_head_dim: int, feedforward_dim: int,
                 cnn_module_kernel: int, warmup_begin: float = 0.0,
                 warmup_end: float = 0.0, final_layerdrop_rate: float = 0.05):
        super().__init__()
        self.pos_dim = pos_dim
        self.time_emb = None
        if time_embed_dim != -1:
            self.time_emb = nn.Sequential(
                SwooshR(), Linear(time_embed_dim, embed_dim)
            )
        self.layers = nn.ModuleList(
            ZipformerEncoderLayer(
                embed_dim, pos_dim, num_heads, query_head_dim, pos_head_dim,
                value_head_dim, feedforward_dim, cnn_module_kernel,
                bypass_skip_rate=sched.layerdrop_schedule(
                    warmup_begin, warmup_end, num_layers, i,
                    final_layerdrop_rate=final_layerdrop_rate,
                ),
            )
            for i in range(num_layers)
        )

    def forward(self, src, time_emb=None, key_padding_mask=None,
                train: bool = False, dropout_rate=0.0, batch_count=None,
                gens: Optional[TrainGenerators] = None):
        pos_emb = compact_rel_pos_encoding(
            src.shape[1], self.pos_dim, device=src.device
        ).to(src.dtype)
        if train and not _static_zero(dropout_rate):
            # dropout of 0.15 on the whole positional table, whatever the
            # scheduled rate (a literal 0 rate turns it off)
            keep = _rand_uniform(gens, pos_emb.shape, src.device) >= 0.15
            pos_emb = torch.where(keep, pos_emb / 0.85, 0.0)
        if self.time_emb is not None:
            time_emb = self.time_emb(time_emb)[:, None, :]
        for layer in self.layers:
            src = layer(src, pos_emb, time_emb, key_padding_mask, train=train,
                        dropout_rate=dropout_rate, batch_count=batch_count,
                        gens=gens)
        return src


class SimpleDownsample(nn.Module):
    """Holds the softmax-normalized weights of a downsampling group."""

    def __init__(self, downsample_factor: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(downsample_factor))


class EncoderStack(nn.Module):
    """A downsampled U-Net stack (factor > 1): weighted temporal
    downsampling, a ZipformerEncoder at T/ds, repeat-upsampling and a
    bypass combiner.  Stacks with factor 1 are a bare ZipformerEncoder, as
    in the reference's state_dict layout."""

    def __init__(self, downsample_factor: int, embed_dim: int, **encoder_kw):
        super().__init__()
        self.downsample_factor = downsample_factor
        self.downsample = SimpleDownsample(downsample_factor)
        self.encoder = ZipformerEncoder(embed_dim=embed_dim, **encoder_kw)
        self.out_combiner = BypassModule(embed_dim)

    def forward(self, src, time_emb=None, key_padding_mask=None,
                train: bool = False, dropout_rate=0.0, batch_count=None,
                gens: Optional[TrainGenerators] = None):
        ds = self.downsample_factor
        src_orig = src
        B, T, C = src.shape
        if key_padding_mask is not None:
            # Frames past the batch's longest valid length (the global
            # batch's, under a process group) repeat the frame at that
            # boundary, so the downsample groups average what the
            # reference's exact-length, repeat-padded run averages.
            valid_max = mesh.global_max((~key_padding_mask).sum(dim=1).max())
            idx = torch.minimum(
                torch.arange(T, device=src.device),
                (valid_max - 1).clamp(min=0),
            )
            src = src.index_select(1, idx)
        d_seq_len = (T + ds - 1) // ds
        pad = d_seq_len * ds - T
        if pad > 0:
            src = torch.cat([src, src[:, -1:].expand(B, pad, C)], dim=1)
        weights = torch.softmax(self.downsample.bias, dim=0).to(src.dtype)
        src = (src.reshape(B, d_seq_len, ds, C)
               * weights[None, None, :, None]).sum(dim=2)
        mask_ds = None
        if key_padding_mask is not None:
            mask_ds = key_padding_mask[:, ::ds]
        src = self.encoder(src, time_emb, mask_ds, train=train,
                           dropout_rate=dropout_rate, batch_count=batch_count,
                           gens=gens)
        src = src.repeat_interleave(ds, dim=1)[:, :T]
        return self.out_combiner(src_orig, src, train=train,
                                 batch_count=batch_count if train else None,
                                 gens=gens)


class TTSZipformer(nn.Module):
    """The full TTS Zipformer: (B, T, in_dim) [+ t (B,), padding_mask
    (B, T), guidance_scale (B,)] -> (B, T, out_dim).  Stack i's layerdrop
    warm-up spans [i + 1, i + 2] / (stacks + 1) of ``warmup_batches``.

    Two-stream mode (ZipVoice-Dialog-Stereo): with 2-tuples for ``in_dim``
    and ``out_dim``, ``in_proj`` and ``out_proj`` hold one Linear per
    stream around the shared trunk, and the input's last dimension picks
    the stream: ``in_dim[0]`` wide takes projections 0, ``in_dim[1]`` wide
    projections 1 (the reference's ``in_proj.0`` ... ``out_proj.1``)."""

    def __init__(self, in_dim: Union[int, Tuple[int, int]],
                 out_dim: Union[int, Tuple[int, int]],
                 downsampling_factor: Sequence[int] = (2, 4),
                 num_encoder_layers: Sequence[int] = (4,),
                 cnn_module_kernel: Sequence[int] = (31,),
                 encoder_dim: int = 384, query_head_dim: int = 24,
                 pos_head_dim: int = 4, value_head_dim: int = 12,
                 num_heads: int = 8, feedforward_dim: int = 1536,
                 pos_dim: int = 192, use_time_embed: bool = True,
                 time_embed_dim: int = 192,
                 use_guidance_scale_embed: bool = False,
                 guidance_scale_embed_dim: int = 192,
                 warmup_batches: float = 4000.0):
        super().__init__()
        n = len(downsampling_factor)

        def per_stack(val):
            val = tuple(val)
            return val * n if len(val) == 1 else val

        num_layers = per_stack(num_encoder_layers)
        kernels = per_stack(cnn_module_kernel)
        self.time_embed_dim = time_embed_dim
        self.guidance_scale_embed_dim = guidance_scale_embed_dim
        self.in_dims = (tuple(in_dim) if isinstance(in_dim, (tuple, list))
                        else None)
        if self.in_dims is None:
            self.in_proj = Linear(in_dim, encoder_dim)
        else:
            self.in_proj = nn.ModuleList(
                [Linear(d, encoder_dim) for d in in_dim]
            )
        if use_time_embed:
            self.time_embed = nn.Sequential(
                Linear(time_embed_dim, time_embed_dim * 2), SwooshR(),
                Linear(time_embed_dim * 2, time_embed_dim),
            )
        if use_guidance_scale_embed:
            self.guidance_scale_embed = Linear(
                guidance_scale_embed_dim, time_embed_dim, bias=False,
                initial_scale=0.1,
            )
        stacks = []
        for i, ds in enumerate(downsampling_factor):
            kw = dict(
                num_layers=num_layers[i],
                time_embed_dim=time_embed_dim if use_time_embed else -1,
                pos_dim=pos_dim, num_heads=num_heads,
                query_head_dim=query_head_dim, pos_head_dim=pos_head_dim,
                value_head_dim=value_head_dim,
                feedforward_dim=feedforward_dim,
                cnn_module_kernel=kernels[i],
                warmup_begin=warmup_batches * (i + 1) / (n + 1),
                warmup_end=warmup_batches * (i + 2) / (n + 1),
                final_layerdrop_rate=0.035 * (ds ** 0.5),
            )
            stacks.append(
                ZipformerEncoder(embed_dim=encoder_dim, **kw) if ds == 1
                else EncoderStack(ds, encoder_dim, **kw)
            )
        self.encoders = nn.ModuleList(stacks)
        self.out_proj = (
            Linear(encoder_dim, out_dim) if self.in_dims is None
            else nn.ModuleList([Linear(encoder_dim, d) for d in out_dim])
        )

    def forward(self, x, t: Optional[torch.Tensor] = None,
                padding_mask: Optional[torch.Tensor] = None,
                guidance_scale: Optional[torch.Tensor] = None,
                train: bool = False, dropout_rate=0.0, batch_count=None,
                gens: Optional[TrainGenerators] = None):
        """``dropout_rate=None`` follows the scheduled 0.3 -> 0.1 ramp."""
        if dropout_rate is None:
            dropout_rate = sched.DROPOUT(batch_count if train else None)
        in_proj, out_proj = self.in_proj, self.out_proj
        if self.in_dims is not None:
            if x.shape[-1] not in self.in_dims:
                raise ValueError(
                    f"input width {x.shape[-1]} is neither stream's "
                    f"{self.in_dims}"
                )
            index = self.in_dims.index(x.shape[-1])
            in_proj, out_proj = in_proj[index], out_proj[index]
        x = in_proj(x)
        time_emb = None
        if t is not None:
            time_emb = timestep_embedding(t, self.time_embed_dim)
            if guidance_scale is not None:
                time_emb = time_emb + self.guidance_scale_embed(
                    timestep_embedding(
                        guidance_scale, self.guidance_scale_embed_dim
                    )
                )
            time_emb = self.time_embed(time_emb)
        for stack in self.encoders:
            x = stack(x, time_emb, padding_mask, train=train,
                      dropout_rate=dropout_rate, batch_count=batch_count,
                      gens=gens)
        return out_proj(x)
