"""Load reference-layout checkpoints into the port (counterpart of
``zipvoice_tpu/utils/checkpoint_io.py``: ``load_torch_state_dict``,
``load_model_dir`` and ``load_vocos``).

The reference distributes models as ``{model_dir}/model.pt, model.json,
tokens.txt`` (reference zipvoice/bin/infer_zipvoice.py:757-816), optionally
``model.safetensors``; the port's modules use that key layout, so a file
loads with ``strict=True`` and no conversion.  The modules are built on the
meta device and take the loaded CPU tensors as their parameters, so the
weights are held once on the host before they move to the device.

Training checkpoints (``save_checkpoint``/``load_checkpoint``, the
counterparts of the JAX package's orbax pair) are directories: the model's
``state_dict`` in the reference layout as ``model.pt`` (loadable by
``load_torch_state_dict`` and ``--checkpoint``), the trainer's state (the
ScaledAdam state, the step, the generators) as ``train_state.pt``, and
``extra.json`` (the sampler state, the batch count, the averaging period).
"""

import json
import logging
import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from zipvoice_torch.frontend.tokenizer import DialogTokenizer, EmiliaTokenizer
from zipvoice_torch.models.dialog import ZipVoiceDialog, ZipVoiceDialogStereo
from zipvoice_torch.models.zipformer import set_compute_dtype
from zipvoice_torch.models.zipvoice import ZipVoice, ZipVoiceDistill
from zipvoice_torch.utils.device import resolve_device
from zipvoice_torch.vocoder.vocos import Vocos, build_vocos

MODEL_CLASSES = {
    "zipvoice": ZipVoice,
    "zipvoice_distill": ZipVoiceDistill,
    "zipvoice_dialog": ZipVoiceDialog,
    "zipvoice_dialog_stereo": ZipVoiceDialogStereo,
}
DIALOG_MODELS = ("zipvoice_dialog", "zipvoice_dialog_stereo")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pt`` (with or without a ``"model"`` key) or ``.safetensors``
    file -> a flat ``state_dict`` of CPU tensors."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path, device="cpu")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return dict(ckpt)


def _load_into(module_fn, state_dict):
    """``module_fn()`` built on the meta device, with the tensors of
    ``state_dict`` as its parameters (a strict load)."""
    with torch.device("meta"):
        module = module_fn()
    module.load_state_dict(state_dict, strict=True, assign=True)
    return module


def load_model_dir(model_dir: str, model_name: str = "zipvoice",
                   dtype: torch.dtype = torch.float32, device="cuda"
                   ) -> Tuple[ZipVoice, EmiliaTokenizer]:
    """(model, tokenizer) from a reference-layout model dir:
    model.pt|model.safetensors + model.json + tokens.txt.  The model is
    built from model.json, loads the checkpoint with ``strict=True``, then
    computes its matmuls and convs in ``dtype`` and moves to ``device``
    (CUDA unless the caller asks for the CPU).  The dialog models read
    their tokens with a ``DialogTokenizer``, whose [S1]/[S2] ids they
    take."""
    cls = MODEL_CLASSES[model_name]
    device = resolve_device(device)
    with open(os.path.join(model_dir, "model.json")) as f:
        model_config = json.load(f)["model"]
    token_file = os.path.join(model_dir, "tokens.txt")
    extra = {}
    if model_name in DIALOG_MODELS:
        tokenizer = DialogTokenizer(token_file)
        extra = dict(spk_a_id=tokenizer.spk_a_id,
                     spk_b_id=tokenizer.spk_b_id)
    else:
        tokenizer = EmiliaTokenizer(token_file)

    ckpt_path = os.path.join(model_dir, "model.pt")
    if not os.path.exists(ckpt_path):
        ckpt_path = os.path.join(model_dir, "model.safetensors")
    model = _load_into(
        lambda: cls(**model_config, vocab_size=tokenizer.vocab_size,
                    pad_id=tokenizer.pad_id, **extra),
        load_torch_state_dict(ckpt_path),
    )
    for backbone in (model.fm_decoder, model.text_encoder):
        set_compute_dtype(backbone, dtype)
    return model.to(device).eval(), tokenizer


def vocos_config(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The Vocos widths of a published-layout ``state_dict``."""
    embed = state_dict["backbone.embed.weight"]  # (dim, n_mels, 7)
    num_layers = 0
    while f"backbone.convnext.{num_layers}.gamma" in state_dict:
        num_layers += 1
    return dict(
        n_mels=embed.shape[1], dim=embed.shape[0],
        intermediate_dim=state_dict[
            "backbone.convnext.0.pwconv1.weight"].shape[0],
        num_layers=num_layers,
        n_fft=state_dict["head.out.weight"].shape[0] - 2,
    )


def load_vocos(path: Optional[str], dtype: torch.dtype = torch.float32,
               device="cuda") -> Vocos:
    """The Vocos vocoder from a published ``pytorch_model.bin`` (its
    widths read from the file; the file's STFT and mel buffers, which the
    port computes itself, are left out), or with ``build_vocos``'s seeded
    random weights when ``path`` is None."""
    if not path:
        logging.warning(
            "no --vocoder-path: vocoder is RANDOMLY initialized; output "
            "audio will be noise (features are still valid)"
        )
        return build_vocos(device=device, dtype=dtype)
    device = resolve_device(device)
    sd = {k: v for k, v in load_torch_state_dict(path).items()
          if k.startswith(("backbone.", "head.out."))}
    vocos = _load_into(lambda: Vocos(**vocos_config(sd)), sd)
    set_compute_dtype(vocos.backbone, dtype)
    return vocos.to(device).eval()


# --- training checkpoints ----------------------------------------------------


def save_checkpoint(path: str, model_state: Mapping[str, torch.Tensor],
                    train_state: Optional[Dict[str, Any]] = None,
                    extra: Optional[dict] = None) -> None:
    """Write the checkpoint directory ``path`` (replacing one that is
    there): ``model_state`` (moved to the CPU) as ``model.pt``,
    ``train_state`` as ``train_state.pt`` and ``extra`` as ``extra.json``,
    each when given.  The directory is written beside and renamed into
    place, so a reader never sees half of one."""
    path = os.path.abspath(path)
    tmp = f"{path}.{os.getpid()}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save({"model": {k: v.detach().cpu()
                          for k, v in model_state.items()}},
               os.path.join(tmp, "model.pt"))
    if train_state is not None:
        torch.save(train_state, os.path.join(tmp, "train_state.pt"))
    if extra is not None:
        with open(os.path.join(tmp, "extra.json"), "w") as f:
            json.dump(extra, f)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor],
                                        Optional[Dict[str, Any]],
                                        Optional[dict]]:
    """(model state_dict, train state or None, extra or None) of a
    checkpoint directory written by ``save_checkpoint``, on the CPU."""
    model_state = load_torch_state_dict(os.path.join(path, "model.pt"))
    train_state = None
    train_path = os.path.join(path, "train_state.pt")
    if os.path.exists(train_path):
        train_state = torch.load(train_path, map_location="cpu",
                                 weights_only=True)
    extra = None
    extra_path = os.path.join(path, "extra.json")
    if os.path.exists(extra_path):
        with open(extra_path) as f:
            extra = json.load(f)
    return model_state, train_state, extra
