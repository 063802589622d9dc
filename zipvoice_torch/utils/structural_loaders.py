"""Structural checkpoint transforms for fine-tuning initialization
(counterpart of ``zipvoice_tpu/utils/structural_loaders.py``).

Reference zipvoice/utils/checkpoint.py:147-229:
- ``extend_vocab``: initialize a Dialog model from a base ZipVoice
  checkpoint: the embedding table grows to the new vocabulary keeping the
  original rows, and ``spk_embed`` starts fresh;
- ``copy_proj_three_channel``: initialize the Stereo model's two-stream
  fm_decoder projections from the mono Dialog decoder: the stream-0 input
  projection splits the mono weights across the doubled channels
  ([xt/2, xt/2, text, cond/2, cond/2]) and the stream-0 output projection
  duplicates rows; stream 1 keeps the originals.

These work on reference-layout ``state_dict``s (the port's layout, the one
``--init-from-base`` and ``--init-from-dialog`` load), with the JAX
package's random draws, so the same seed gives the same tensors.
"""

from typing import Dict

import numpy as np
import torch


def extend_vocab(state_dict: Dict[str, torch.Tensor], new_vocab_size: int,
                 rng=None, feat_dim: int = 100) -> Dict[str, torch.Tensor]:
    """Grow ``embed.weight`` to ``new_vocab_size`` rows; add a fresh
    ``spk_embed.weight``."""
    emb = state_dict["embed.weight"].float().numpy()
    old_v, d = emb.shape
    assert new_vocab_size >= old_v, (new_vocab_size, old_v)
    rng = rng or np.random.RandomState(0)
    new_emb = rng.normal(0, 1.0, (new_vocab_size, d)).astype(np.float32)
    new_emb[:old_v] = emb
    out = dict(state_dict)
    out["embed.weight"] = torch.from_numpy(new_emb)
    if "spk_embed.weight" not in out:
        out["spk_embed.weight"] = torch.from_numpy(
            rng.normal(0, 0.1, (2, feat_dim)).astype(np.float32))
    return out


def copy_proj_three_channel(state_dict: Dict[str, torch.Tensor],
                            feat_dim: int) -> Dict[str, torch.Tensor]:
    """Mono dialog decoder -> two-stream stereo decoder projections:
    ``fm_decoder.in_proj`` (D, 3F) becomes ``in_proj.0`` (D, 5F) and
    ``in_proj.1`` (the original); ``out_proj`` (F, D) becomes
    ``out_proj.0`` (2F, D) and ``out_proj.1``."""
    F = feat_dim
    out = dict(state_dict)
    w = out.pop("fm_decoder.in_proj.weight")
    b = out.pop("fm_decoder.in_proj.bias")
    out["fm_decoder.in_proj.0.weight"] = torch.cat(
        [w[:, :F] / 2, w[:, :F] / 2, w[:, F: 2 * F], w[:, 2 * F:] / 2,
         w[:, 2 * F:] / 2], dim=1)
    out["fm_decoder.in_proj.0.bias"] = b
    out["fm_decoder.in_proj.1.weight"] = w
    out["fm_decoder.in_proj.1.bias"] = b
    w = out.pop("fm_decoder.out_proj.weight")
    b = out.pop("fm_decoder.out_proj.bias")
    out["fm_decoder.out_proj.0.weight"] = torch.cat([w, w], dim=0)
    out["fm_decoder.out_proj.0.bias"] = torch.cat([b, b], dim=0)
    out["fm_decoder.out_proj.1.weight"] = w
    out["fm_decoder.out_proj.1.bias"] = b
    return out


def graft_missing(dst: Dict, src: Dict) -> Dict:
    """Recursively add the entries of ``src`` absent from ``dst`` (in
    place), for flat ``state_dict``s and nested trees alike.

    The JAX trainer needs it for the two-stream model's from-scratch init
    (flax creates only the projection pair its init input exercises); the
    port's two-stream ``TTSZipformer`` builds both pairs, as the reference
    does (zipvoice_dialog.py:241-256), so its trainer grafts nothing."""
    for k, v in src.items():
        if k not in dst:
            dst[k] = v
        elif isinstance(v, dict):
            graft_missing(dst[k], v)
    return dst
