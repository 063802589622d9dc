"""Carry JAX-package parameters over to the port's ``state_dict`` layout.

The port's modules use the reference torch key layout, so published
checkpoints load directly.  These functions turn a flax parameter tree of
``zipvoice_tpu`` (as numpy arrays) into that layout; they are the port's own
numpy-only copies of the inverse conversions in
``zipvoice_tpu/utils/convert.py`` and ``zipvoice_tpu/vocoder/vocos.py``.
Layout changes undone here, each key's by ``port_layout``: flax Dense
kernels (in, out) become Linear weights (out, in); (k, C) depthwise filters
become Conv1d weights (C, 1, k); flax scope names (``layers_0``,
``time_embed_in``, ...) become module paths.
Any tree shaped like the params converts the same way: the tests carry JAX
gradients and JAX-updated parameters across with these functions.
"""

import re
from typing import Any, Dict, Iterator, Mapping, Sequence, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
             ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _tensors(arrays: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in arrays.items()}


def port_layout(key: str) -> str:
    """How the port's tensor under ``key`` lays out the flax leaf that it
    converts from: "dw" for a depthwise filter (flax (k, C), torch
    (C, 1, k)), "conv" for the Vocos input conv (flax (k, in, out), torch
    (out, in, k)), "linear" for any other ``.weight`` but the embeddings'
    (a flax Dense kernel (in, out), torch (out, in); the transpose leaves
    the one-axis norm weights as they are), "same" for everything else."""
    if key.endswith(("depthwise_conv.weight", "dwconv.weight")):
        return "dw"
    if key == "backbone.embed.weight":
        return "conv"
    if key in ("embed.weight", "spk_embed.weight") or not key.endswith(
            ".weight"):
        return "same"
    return "linear"


def from_flax(key: str, a: np.ndarray) -> np.ndarray:
    """The flax leaf ``a`` in the layout of the port's tensor ``key``."""
    layout = port_layout(key)
    if layout == "dw":
        return a.T[:, None, :]
    if layout == "conv":
        return a.transpose(2, 1, 0)
    return a.T if layout == "linear" else a


def to_flax(key: str, a: np.ndarray) -> np.ndarray:
    """The port's tensor ``key`` (as numpy) in its flax leaf's layout:
    the inverse of ``from_flax``."""
    layout = port_layout(key)
    if layout == "dw":
        return a[:, 0, :].T
    if layout == "conv":
        return a.transpose(2, 1, 0)
    return a.T if layout == "linear" else a


def zipformer_state_dict(tree: Mapping[str, Any], prefix: str = "",
                         downsampling_factors: Sequence[int] = ()
                         ) -> Dict[str, torch.Tensor]:
    """Flax params of a TTSZipformer, or of any module inside one, -> the
    port's keys under ``prefix``; ``downsampling_factors`` are the stacks'
    factors when the tree holds stacks."""
    out = {}
    for path, v in _flatten(tree):
        k = ".".join(path)
        v = np.asarray(v, dtype=np.float32)
        k = k.replace(".time_emb_proj.", ".time_emb.1.")
        k = k.replace("time_embed_in.", "time_embed.0.")
        k = k.replace("time_embed_out.", "time_embed.2.")
        k = re.sub(r"\blayers_(\d+)\.", r"layers.\1.", k)
        # the two-stream decoder's projection pairs (ZipVoice-Dialog-Stereo)
        k = re.sub(r"\b(in_proj|out_proj)_([01])\.", r"\1.\2.", k)
        if k.endswith(".downsample_bias"):
            k = k[: -len("_bias")] + ".bias"
        m = re.match(r"encoders_(\d+)\.(.*)", k)
        if m:
            i, rest = int(m.group(1)), m.group(2)
            # the reference nests an ``encoder`` scope only in downsampled
            # stacks
            if downsampling_factors[i] == 1 and rest.startswith("encoder."):
                rest = rest[len("encoder."):]
            k = f"encoders.{i}.{rest}"
        if k.endswith("depthwise_weight"):
            k = k.replace("depthwise_weight", "depthwise_conv.weight")
        elif k.endswith("depthwise_bias"):
            k = k.replace("depthwise_bias", "depthwise_conv.bias")
        elif k.endswith(".kernel"):
            k = k[: -len(".kernel")] + ".weight"
        out[prefix + k] = from_flax(prefix + k, v)
    return _tensors(out)


def state_dict_from_jax_params(
    params: Mapping[str, Any],
    downsampling_factors: Mapping[str, Sequence[int]],
) -> Dict[str, torch.Tensor]:
    """Flax ZipVoice params (the contents of ``variables["params"]``) ->
    the port's ``state_dict``; the dialog models' ``spk_embed`` and the
    stereo model's projection pairs included.  ``downsampling_factors``
    maps "fm_decoder" and "text_encoder" to their stacks' factors, e.g.
    {"fm_decoder": (1, 2, 4, 2, 1), "text_encoder": (1,)}."""
    out = _tensors({
        f"{name}.weight": np.asarray(params[name]["embedding"], np.float32)
        for name in ("embed", "spk_embed") if name in params
    })
    for name in ("fm_decoder", "text_encoder"):
        out.update(zipformer_state_dict(
            params[name], name + ".", downsampling_factors[name]
        ))
    return out


def vocos_state_dict_from_jax_params(
    params: Mapping[str, Any]
) -> Dict[str, torch.Tensor]:
    """Flax Vocos params -> the published Vocos ``state_dict`` layout
    (the inverse of ``zipvoice_tpu.vocoder.vocos.convert_vocos_state_dict``).
    """
    def f32(v):
        return np.asarray(v, dtype=np.float32)

    def norm(key, p):
        return {f"{key}.weight": f32(p["scale"]),
                f"{key}.bias": f32(p["bias"])}

    sd = {
        "backbone.embed.weight": f32(params["embed_weight"]),
        "backbone.embed.bias": f32(params["embed_bias"]),
        **norm("backbone.norm", params["norm"]),
        **norm("backbone.final_layer_norm", params["final_layer_norm"]),
        "head.out.weight": f32(params["head_out"]["kernel"]),
        "head.out.bias": f32(params["head_out"]["bias"]),
    }
    i = 0
    while f"convnext_{i}" in params:
        blk, key = params[f"convnext_{i}"], f"backbone.convnext.{i}"
        sd[f"{key}.dwconv.weight"] = f32(blk["dwconv_weight"])
        sd[f"{key}.dwconv.bias"] = f32(blk["dwconv_bias"])
        sd.update(norm(f"{key}.norm", blk["norm"]))
        for lin in ("pwconv1", "pwconv2"):
            sd[f"{key}.{lin}.weight"] = f32(blk[lin]["kernel"])
            sd[f"{key}.{lin}.bias"] = f32(blk[lin]["bias"])
        sd[f"{key}.gamma"] = f32(blk["gamma"])
        i += 1
    return _tensors({k: from_flax(k, v) for k, v in sd.items()})
