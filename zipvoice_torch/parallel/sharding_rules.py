"""Tensor-parallel plans for the ZipVoice parameters (the port's counterpart
of ``zipvoice_tpu/parallel/sharding_rules.py``).

The 123M model fits one card, so data parallelism is the default
(``parallel/mesh.py``, matching the reference's DDP-only story); tensor
parallelism serves larger variants or very long sequences.  The plan is
Megatron's, as in the JAX package:

- feedforward: in_proj column-parallel (hidden sharded), out_proj
  row-parallel (hidden sharded) — one all-reduce per FF;
- attention projections: in_proj column-parallel over the fused
  (q|k|p)·heads output dim, linear_pos and the value in_proj
  column-parallel, out_proj row-parallel;
- NonlinAttention: in_proj column-parallel over its three ``hidden``
  segments, out_proj row-parallel;
- everything else (norms, biases of row-parallel layers, embeddings,
  convs) replicated.

Biases of column-parallel layers shard with their outputs; biases of
row-parallel layers stay replicated (added after the reduction).

The JAX package names each leaf's spec and lets GSPMD split the last axis
evenly and reshard as needed.  Here each process keeps its slice of the
weights in place (``shard_model``) and the only collective is the SUM
all-reduce after each row-parallel layer, over the process group of
``parallel/mesh.py``; so a slice follows the layout:

- the heads are split in contiguous blocks, one a rank: in
  ``self_attn_weights.in_proj`` each of the q, k and p segments by heads,
  ``linear_pos`` by heads, the value ``in_proj`` (heads·vd) by heads;
- NonlinAttention's ``in_proj`` takes the same block of hidden units from
  each of its three segments; the feed-forward ``in_proj`` a block of
  hidden units;
- NonlinAttention reads head 0's attention weights.  A rank that does not
  hold head 0 computes it too, before its own heads, in the same weights
  call (so the weights kernel still launches once a layer and no (B, T, T)
  tensor crosses processes); its SelfAttentions skip it;
- where the group's size does not divide a module's heads or hidden
  width, that module stays whole on every rank (the JAX package
  replicates such a leaf).

``param_spec`` is the plan's one statement: ``shard_model`` checks every
parameter it splits, and every parameter it leaves whole outside those
modules, against it.  The group's processes hold the same batch, so
``shard_model`` also tells ``parallel/mesh.py`` that nothing batch-wide is
to be all-reduced over it (``mesh.replicate_batch``).

The plan covers what the JAX package's does: the parameters and the
inference forward.  The kernel configuration's fused weights +
NonlinAttention kernel and application kernel are refused
(``ValueError``); the attention weights kernel takes any head count.
"""

import re
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from zipvoice_torch.models.zipformer import (
    FeedforwardModule,
    Linear,
    NonlinAttention,
    ZipformerEncoderLayer,
)
from zipvoice_torch.parallel import mesh

COLUMN = "column"
ROW = "row"

# (state_dict key regex, plan); any other key is replicated
_RULES = [
    (r".*feed_forward\d\.in_proj\.(weight|bias)", COLUMN),
    (r".*feed_forward\d\.out_proj\.weight", ROW),
    (r".*self_attn_weights\.in_proj\.(weight|bias)", COLUMN),
    (r".*self_attn_weights\.linear_pos\.weight", COLUMN),
    (r".*self_attn\d\.in_proj\.(weight|bias)", COLUMN),
    (r".*self_attn\d\.out_proj\.weight", ROW),
    (r".*nonlin_attention\.in_proj\.(weight|bias)", COLUMN),
    (r".*nonlin_attention\.out_proj\.weight", ROW),
]


def param_spec(name: str) -> Optional[str]:
    """The plan of a reference-layout ``state_dict`` key: ``"column"`` (its
    output features split: a weight's rows, a bias), ``"row"`` (its input
    features split: a weight's columns) or None (replicated)."""
    for pattern, plan in _RULES:
        if re.fullmatch(pattern, name):
            return plan
    return None


class RowParallelLinear(Linear):
    """A row-parallel ``Linear``: this rank's columns of the weight, the
    partial products summed over ``group``, then the whole bias.  Inference
    only (the all-reduce carries no gradient)."""

    def __init__(self, linear: Linear, cols: torch.Tensor, group):
        nn.Module.__init__(self)
        self.in_features = len(cols)
        self.out_features = linear.out_features
        self.compute_dtype = linear.compute_dtype
        w = linear.weight
        self.weight = nn.Parameter(w.detach()[:, cols].clone(),
                                   requires_grad=w.requires_grad)
        self.bias = linear.bias
        self.group = group

    def forward(self, x):
        if torch.is_grad_enabled() and x.requires_grad:
            raise RuntimeError("tensor parallelism covers the inference "
                               "forward only")
        dt = self.compute_dtype or self.weight.dtype
        y = F.linear(x.to(dt), self.weight.to(dt))
        dist.all_reduce(y, group=self.group)
        return y + self.bias.to(dt)


def _keep_rows(linear: Linear, rows: torch.Tensor) -> None:
    """``linear`` computes only its output features ``rows``."""
    for name in ("weight", "bias"):
        p = getattr(linear, name)
        if p is not None:
            setattr(linear, name, nn.Parameter(
                p.detach()[rows].clone(), requires_grad=p.requires_grad))
    linear.out_features = len(rows)


def _rows(blocks: List[int], width: int, segments: int = 1,
          segment_width: Optional[int] = None, device=None) -> torch.Tensor:
    """The output features of blocks ``blocks`` (each ``width`` wide) in
    each of ``segments`` segments of ``segment_width`` features."""
    segment_width = segment_width or 0
    idx = [s * segment_width + b * width + i for s in range(segments)
           for b in blocks for i in range(width)]
    return torch.tensor(idx, dtype=torch.long, device=device)


def _block(n: int, rank: int, world: int) -> List[int]:
    """Rank ``rank``'s contiguous block of ``n`` units (``world`` divides
    ``n``)."""
    size = n // world
    return list(range(rank * size, (rank + 1) * size))


# the Linears a helper split, each with its plan; None where the helper
# kept its modules whole
Split = Optional[List[Tuple[nn.Module, str]]]


def _shard_attention(layer: ZipformerEncoderLayer, rank: int, world: int,
                     group) -> Split:
    weights = layer.self_attn_weights
    h = weights.num_heads
    if h % world:
        return None
    qd, pd = weights.query_head_dim, weights.pos_head_dim
    own = _block(h, rank, world)
    computed = own if 0 in own else [0] + own
    dev = weights.in_proj.weight.device
    q = _rows(computed, qd, device=dev)
    k = q + h * qd
    p = _rows(computed, pd, device=dev) + 2 * h * qd
    _keep_rows(weights.in_proj, torch.cat([q, k, p]))
    _keep_rows(weights.linear_pos, _rows(computed, pd, device=dev))
    weights.num_heads = len(computed)
    split = [(weights.in_proj, COLUMN), (weights.linear_pos, COLUMN)]
    for attn in (layer.self_attn1, layer.self_attn2):
        vd = attn.value_head_dim
        cols = _rows(own, vd, device=dev)
        _keep_rows(attn.in_proj, cols)
        split += [(attn.in_proj, COLUMN), (attn.out_proj, ROW)]
        attn.out_proj = RowParallelLinear(attn.out_proj, cols, group)
        attn.num_heads = len(own)
        attn.skip_heads = len(computed) - len(own)
    return split


def _shard_hidden(module: nn.Module, segments: int, rank: int, world: int,
                  group) -> Split:
    """A module of ``in_proj`` (``segments`` segments of ``hidden``
    features) then ``out_proj`` (from ``hidden``): this rank's block of
    hidden units."""
    hidden = module.in_proj.out_features // segments
    if hidden % world:
        return None
    dev = module.in_proj.weight.device
    own = _block(hidden, rank, world)
    _keep_rows(module.in_proj, _rows(own, 1, segments, hidden, device=dev))
    split = [(module.in_proj, COLUMN), (module.out_proj, ROW)]
    module.out_proj = RowParallelLinear(module.out_proj,
                                        _rows(own, 1, device=dev), group)
    return split


def _check_plan(model: nn.Module, applied: dict, whole: List[str]) -> None:
    """Every parameter of ``model`` outside the modules ``whole`` was split
    as ``param_spec`` plans it (``applied``: key -> plan; a key missing
    there stayed whole)."""
    for key, _ in model.named_parameters():
        if any(key.startswith(w + ".") for w in whole):
            continue
        if applied.get(key) != param_spec(key):
            raise RuntimeError(f"{key}: split {applied.get(key)}, but "
                               f"param_spec plans {param_spec(key)}")


def shard_model(model: nn.Module, group=None) -> dict:
    """Keep this process's slice of every tensor-parallel parameter of the
    Zipformer layers under ``model``, in place, over ``group`` (the default
    process group; with none open, or a group of one, nothing changes).
    Every split is checked against ``param_spec``, and the group is marked
    as holding one batch (``mesh.replicate_batch``).  Returns how many
    modules of each kind were split and kept whole."""
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(group), dist.get_world_size(group)
    else:
        rank, world = 0, 1
    counts = {"split": 0, "whole": 0}
    if world == 1:
        return counts
    layers = [m for m in model.modules()
              if isinstance(m, ZipformerEncoderLayer)]
    for layer in layers:
        if layer.fuse_nonlin or layer.self_attn1.use_kernel:
            raise ValueError("the kernel configuration's fused weights + "
                             "NonlinAttention and application kernels do "
                             "not take a tensor-parallel layer")
    names = {m: n for n, m in model.named_modules()}
    applied, whole = {}, []
    for layer in layers:
        hidden = [m for m in layer.modules()
                  if isinstance(m, (NonlinAttention, FeedforwardModule))]
        done = [((layer.self_attn_weights, layer.self_attn1,
                  layer.self_attn2), _shard_attention(layer, rank, world,
                                                      group))]
        done += [((m,), _shard_hidden(m, 3 if isinstance(m, NonlinAttention)
                                      else 1, rank, world, group))
                 for m in hidden]
        for modules, split in done:
            if split is None:
                whole += [names[m] for m in modules]
                counts["whole"] += 1
                continue
            counts["split"] += 1
            for linear, plan in split:
                for name, _ in linear.named_parameters(recurse=False):
                    applied[f"{names[linear]}.{name}"] = (
                        None if plan == ROW and name == "bias" else plan)
    _check_plan(model, applied, whole)
    mesh.replicate_batch()
    return counts
