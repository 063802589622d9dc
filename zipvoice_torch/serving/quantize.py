"""Weight-only int8 for serving (counterpart of
``zipvoice_tpu/serving/quantize.py``).

Matrix parameters are held on the device as int8 with one f32 scale per
output channel, about half the bytes of bf16 between calls, and are
expanded to their compute dtype a part of the model at a time during a
sampling or vocoding call (``InferencePipeline(..., quantize="int8")``);
activations and accumulation keep the model's dtypes.  Each element of a
top-level ``nn.ModuleList`` (a U-Net stack of the fm_decoder, the text
encoder's stack, a Vocos ConvNeXt block) expands its own tensors when its
forward starts and frees them when it returns; the few tensors outside
those lists (the embeddings and the input and output projections) are
expanded for the whole call.  So the expanded bytes alive at once are
bounded by the largest stack plus those few, not by the whole model (the
JAX package's XLA fuses the expansion into the consumers instead), and a
stack that runs once a step expands once a step: in a few launches, one
for each group of its tensors that share a shape past their first axis,
held concatenated along it.

The rule is the JAX package's, leaf for leaf: symmetric int8,
``scale = amax / 127`` in f32, ``q = clip(round(w / scale), -127, 127)``,
for floating leaves of at least two axes and ``_MIN_QUANT_SIZE`` elements.
JAX keeps the last axis of the flax leaf and reduces over the others, so
each tensor is quantized in the layout of the flax leaf that
``utils/convert.py`` maps its key to (``to_flax``), and the result is laid
back out as the port's tensor (``from_flax``): the same bits as JAX's, in
the port's layout.
"""

from typing import Dict, Mapping, Union

import numpy as np
import torch
import torch.nn as nn

from zipvoice_torch.utils.convert import from_flax, to_flax

# leaves smaller than this stay unquantized (biases, norms, scalars:
# negligible bytes, high sensitivity)
_MIN_QUANT_SIZE = 4096

QuantizedStateDict = Dict[str, Union[torch.Tensor, Dict[str, torch.Tensor]]]


def _is_quantized(v) -> bool:
    return isinstance(v, dict) and set(v) == {"q", "scale"}


def quantize_state_dict(state_dict: Mapping[str, torch.Tensor]
                        ) -> QuantizedStateDict:
    """Symmetric per-output-channel int8 of a ``state_dict``'s matrix
    tensors.  Each quantized tensor ``w`` becomes ``{"q": int8, "scale":
    f32}`` on the host, both in ``w``'s layout (the scale with one
    element per output channel and size-1 axes elsewhere), with ``w ≈ q *
    scale``; every other tensor is passed through as it is."""
    out: QuantizedStateDict = {}
    for key, v in state_dict.items():
        if (v.ndim < 2 or not v.is_floating_point()
                or v.numel() < _MIN_QUANT_SIZE):
            out[key] = v
            continue
        w = to_flax(key, v.detach().float().cpu().numpy())
        amax = np.abs(w).max(axis=tuple(range(w.ndim - 1)), keepdims=True)
        scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
        q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
        out[key] = {
            "q": torch.from_numpy(np.ascontiguousarray(from_flax(key, q))),
            "scale": torch.from_numpy(
                np.ascontiguousarray(from_flax(key, scale))),
        }
    return out


def _expand(v: Dict[str, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """One quantized tensor as ``q * scale`` computed in f32 and rounded
    once to ``dtype``: one launch."""
    return torch.mul(v["q"], v["scale"], out=torch.empty(
        v["q"].shape, dtype=dtype, device=v["q"].device))


def dequantize_state_dict(
    qsd: QuantizedStateDict,
    dtype: Union[torch.dtype, Mapping[str, torch.dtype]] = torch.bfloat16,
) -> Dict[str, torch.Tensor]:
    """Inverse of ``quantize_state_dict`` on the tensors' device: each
    quantized tensor as ``q * scale`` computed in f32 and rounded once to
    ``dtype`` (one dtype, or one per key), every other tensor as it is.
    One launch a tensor."""
    out = {}
    for key, v in qsd.items():
        if _is_quantized(v):
            out[key] = _expand(v, dtype if isinstance(dtype, torch.dtype)
                               else dtype[key])
        else:
            out[key] = v
    return out


def quantized_bytes(qsd: QuantizedStateDict) -> int:
    """Bytes of every tensor of ``qsd``, int8 tensors and scales
    included."""
    n = 0
    for v in qsd.values():
        for t in (v.values() if _is_quantized(v) else (v,)):
            n += t.numel() * t.element_size()
    return n


def _unit_of(module: nn.Module, key: str) -> str:
    """The path of the part of ``module`` that expands the tensor ``key``:
    the outermost element of an ``nn.ModuleList`` above it, or "" (the
    whole call) when there is none."""
    parts = key.split(".")[:-1]
    sub = module
    for i, name in enumerate(parts):
        if isinstance(sub, nn.ModuleList):
            return ".".join(parts[: i + 1])
        sub = getattr(sub, name)
    return ""


class Int8Weights:
    """``module``'s weights, quantized by ``quantize_state_dict``, held on
    its device in place of its own: the module keeps its small tensors, and
    each quantized parameter becomes a placeholder on the meta device, so
    that nothing runs the module on weights it no longer has.

    ``self(method, *args, **kwargs)`` runs ``module.<method>`` with the
    int8 tensors expanded to the dtypes the module had: those outside the
    module's ``nn.ModuleList``s for the whole call, each list element's
    in a forward pre-hook of that element, freed by its forward hook.  A
    part's tensors are held in groups, each concatenated along its first
    axis (those whose scale runs along that axis and whose other axes and
    dtype agree), so a group expands in one launch and its tensors are row
    slices of the result.  The expanded tensors stand in the module's
    parameter slots only while they live, so one thread at a time may call
    it."""

    def __init__(self, module: nn.Module):
        state = module.state_dict()
        device = next(module.parameters()).device
        self.dtypes = {k: v.dtype for k, v in state.items()}
        quantized = {k: v for k, v in quantize_state_dict(state).items()
                     if _is_quantized(v)}
        self.units: Dict[str, list] = {}
        for key in quantized:
            self.units.setdefault(_unit_of(module, key), []).append(key)
        # per part: [(int8, scales, dtype, [(key, first row, end row)])]
        self._groups: Dict[str, list] = {}
        self.weights = {}
        for unit, keys in self.units.items():
            members: Dict[tuple, list] = {}
            for key in keys:
                q, scale = quantized[key]["q"], quantized[key]["scale"]
                by_row = (scale.shape[0] == q.shape[0]
                          and all(n == 1 for n in scale.shape[1:]))
                members.setdefault(
                    (tuple(q.shape[1:]), self.dtypes[key]) if by_row
                    else (key,), []).append(key)
            self._groups[unit] = []
            for group in members.values():
                q = torch.cat([quantized[k]["q"] for k in group]).to(device)
                scale = torch.cat(
                    [quantized[k]["scale"] for k in group]).to(device)
                rows, start = [], 0
                for key in group:
                    end = start + quantized[key]["q"].shape[0]
                    rows.append((key, start, end))
                    self.weights[key] = {"q": q[start:end],
                                         "scale": scale[start:end]}
                    start = end
                self._groups[unit].append(
                    (q, scale, self.dtypes[group[0]], rows))
        # each quantized parameter's slot: its owner's parameter dict and
        # name, and the placeholder that fills it between expansions
        self._slots = {}
        for key, v in self.weights.items():
            owner, _, name = key.rpartition(".")
            placeholder = nn.Parameter(
                torch.empty(v["q"].shape, dtype=self.dtypes[key],
                            device="meta"), requires_grad=False)
            sub = module.get_submodule(owner)
            setattr(sub, name, placeholder)
            self._slots[key] = (sub._parameters, name, placeholder)
        for unit in self.units:
            if unit:
                sub = module.get_submodule(unit)
                sub.register_forward_pre_hook(
                    lambda m, args, unit=unit: self._swap_in(unit))
                sub.register_forward_hook(
                    lambda m, args, out, unit=unit: self._swap_out(unit))
        self.module = module

    def _swap_in(self, unit: str) -> None:
        for q, scale, dtype, rows in self._groups.get(unit, ()):
            full = _expand({"q": q, "scale": scale}, dtype)
            for key, start, end in rows:
                params, name, _ = self._slots[key]
                params[name] = full[start:end]

    def _swap_out(self, unit: str) -> None:
        for key in self.units.get(unit, ()):
            params, name, placeholder = self._slots[key]
            params[name] = placeholder

    def __call__(self, method: str, *args, **kwargs):
        self._swap_in("")
        try:
            return getattr(self.module, method)(*args, **kwargs)
        finally:
            self._swap_out("")

    def resident_bytes(self) -> int:
        """Bytes of the weights on the device: the int8 tensors, their
        scales and the module's own parameters that stay."""
        return quantized_bytes(self.weights) + sum(
            p.numel() * p.element_size() for p in self.module.parameters()
            if p.device.type != "meta")
