"""Weight-only int8 for serving (counterpart of
``zipvoice_tpu/serving/quantize.py``).

Matrix parameters are held on the device as int8 with one f32 scale per
output channel, about half the bytes of bf16 between calls, and are
expanded to their compute dtype once per sampling or vocoding call
(``InferencePipeline(..., quantize="int8")``); activations and
accumulation keep the model's dtypes.  The expansion is a whole copy of
the weights in their compute dtype that lives for the call (the JAX
package's XLA fuses it into the consumers instead), so the peak during a
request lies above the bf16 pipeline's, by about the int8 bytes, and the
caching allocator keeps that peak reserved: int8 here lowers the bytes
held at rest, not the peak.

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
            dt = dtype if isinstance(dtype, torch.dtype) else dtype[key]
            out[key] = torch.mul(
                v["q"], v["scale"],
                out=torch.empty(v["q"].shape, dtype=dt,
                                device=v["q"].device),
            )
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


class _Method(nn.Module):
    """``module.<method>(...)`` as a forward, so that
    ``torch.func.functional_call`` can run any method of ``module``."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module

    def forward(self, method: str, *args, **kwargs):
        return getattr(self.module, method)(*args, **kwargs)


class Int8Weights:
    """``module``'s weights, quantized by ``quantize_state_dict``, held on
    its device in place of its own: the module keeps its small tensors, and
    each quantized parameter becomes a placeholder on the meta device, so
    that nothing runs the module on weights it no longer has.

    ``self(method, *args, **kwargs)`` expands the int8 tensors to the
    dtypes the module had, once, into a copy that lives for the call, and
    runs ``module.<method>`` on them (``torch.func.functional_call``).  It changes the module for the
    length of the call, so one thread at a time may call it."""

    def __init__(self, module: nn.Module):
        state = module.state_dict()
        device = next(module.parameters()).device
        self.dtypes = {k: v.dtype for k, v in state.items()}
        self.weights = {
            k: {n: t.to(device) for n, t in v.items()}
            for k, v in quantize_state_dict(state).items() if _is_quantized(v)
        }
        for key, v in self.weights.items():
            owner, _, name = key.rpartition(".")
            setattr(module.get_submodule(owner), name, nn.Parameter(
                torch.empty(v["q"].shape, dtype=self.dtypes[key],
                            device="meta"), requires_grad=False))
        self.module = module
        self._method = _Method(module)

    def __call__(self, method: str, *args, **kwargs):
        weights = dequantize_state_dict(self.weights, self.dtypes)
        return torch.func.functional_call(
            self._method, {"module." + k: v for k, v in weights.items()},
            (method, *args), kwargs)

    def resident_bytes(self) -> int:
        """Bytes of the weights on the device: the int8 tensors, their
        scales and the module's own parameters that stay."""
        return quantized_bytes(self.weights) + sum(
            p.numel() * p.element_size() for p in self.module.parameters()
            if p.device.type != "meta")
