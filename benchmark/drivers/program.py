"""The system under test, built for a run: the port's pipeline over weights
the benchmark drew, and the records the harness keeps around its sample
calls.  The wrapping is done from outside the program, on the pipeline
instance."""

import os
import re
import time
from typing import List

import numpy as np

from benchmark.harness import BENCH_DIR, seed_for
from benchmark.reference import frontend as fe
from benchmark.reference.model import vocos_shapes, zipvoice_shapes
from benchmark.weights import make_weights


def build_weights(config: dict, seed: int, device):
    """(model weights, vocoder weights) on ``device``, in the type they are
    served in: those that ``dtype_params`` names in the configuration's
    dtype, the rest in float32."""
    import torch

    P = make_weights(zipvoice_shapes(config["model"]),
                     config["init"], seed_for(seed, "model"), device)
    V = make_weights(vocos_shapes(config["vocoder"]), config["init"],
                     seed_for(seed, "vocoder"), device)
    low = [re.compile(r) for r in config.get("dtype_params", [])]
    dtype = getattr(torch, config["dtype"])
    for weights in (P, V):
        for name, value in weights.items():
            if any(r.search(name) for r in low):
                weights[name] = value.to(dtype)
    return P, V


def build_pipeline(config: dict, P, V, device):
    """The port's ``InferencePipeline`` over the configuration's model and
    vocoder holding the weights ``P`` and ``V``, in the configuration's
    dtype, with the Emilia tokenizer over the benchmark's token table."""
    import torch

    from zipvoice_torch.frontend.tokenizer import EmiliaTokenizer
    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.models import zipvoice
    from zipvoice_torch.models.zipformer import (set_compute_dtype,
                                                 set_kernel_config)
    from zipvoice_torch.vocoder.vocos import Vocos

    dtype = getattr(torch, config["dtype"])
    with torch.device("meta"):
        model = getattr(zipvoice, config["model_class"])(**config["model"])
        vocoder = Vocos(**config["vocoder"])
    model = model.to_empty(device=device).eval()
    for backbone in (model.fm_decoder, model.text_encoder):
        set_compute_dtype(backbone, dtype)
    set_kernel_config(model, False)
    model.load_state_dict(P)
    vocoder = vocoder.to_empty(device=device).eval()
    set_compute_dtype(vocoder.backbone, dtype)
    vocoder.load_state_dict(V)
    tokenizer = EmiliaTokenizer(os.path.join(BENCH_DIR, "data", "tokens.txt"))
    return InferencePipeline(model, vocoder, device=device,
                             tokenizer=tokenizer)


def time_kernel_builds() -> dict:
    """Wrap the port's kernel build (``kernels/_build.build``, which its
    ``load_library`` calls at a kernel's first use) so that the returned
    dict adds up the seconds spent in it (``build_s``) and says whether
    ``nvcc`` ran (``nvcc_ran``: a library was missing from the checkout's
    build directory)."""
    from zipvoice_torch.kernels import _build

    spent = {"build_s": 0.0, "nvcc_ran": False}
    orig = _build.build

    def timed(names):
        missing = any(not os.path.exists(_build.library_path(n))
                      for n in names)
        t0 = time.monotonic()
        try:
            return orig(names)
        finally:
            spent["build_s"] += time.monotonic() - t0
            spent["nvcc_ran"] = spent["nvcc_ran"] or missing

    _build.build = timed
    return spent


def record_sample_calls(pipe, records: List[dict]):
    """Wrap ``pipe._sample_batch_device`` so that each call appends
    {t, enqueue_s, B_real, B, T, fl, S, pfl}: its end and the host's
    seconds in it, the real rows, the batch and frame buckets, each real
    row's total and prompt frames and tokens (prompt, text and the
    trailing pad)."""
    orig = pipe._sample_batch_device

    def recorded(batch_tokens, prompt_tokens, prompt_features, **kw):
        n = len(batch_tokens)
        if prompt_tokens and isinstance(prompt_tokens[0], (list, tuple)):
            p_rows = [list(t) for t in prompt_tokens]
        else:
            p_rows = [list(prompt_tokens)] * n
        f_rows = (list(prompt_features)
                  if isinstance(prompt_features, (list, tuple))
                  else [prompt_features] * n)
        speed = kw.get("speed", 1.0)
        speed = list(speed) if np.ndim(speed) else [speed] * n
        pfl = [f.shape[0] for f in f_rows]
        fl = fe.predicted_frames(pfl, [len(p) for p in p_rows],
                                 [len(t) for t in batch_tokens], speed)
        fl = np.minimum(fl, fe.FRAME_BUCKETS[-1])
        t0 = time.monotonic()
        out = orig(batch_tokens, prompt_tokens, prompt_features, **kw)
        t1 = time.monotonic()
        B, T = out[0].shape[:2]
        records.append({
            "t": t1, "enqueue_s": t1 - t0, "B_real": n, "B": int(B),
            "T": int(T),
            "fl": [int(x) for x in fl], "pfl": [int(x) for x in pfl],
            "S": [len(p) + len(t) + 1 for p, t in zip(p_rows, batch_tokens)]})
        return out

    pipe._sample_batch_device = recorded


def sample_flops(rec: dict, config: dict) -> int:
    """The operations the real rows of one recorded sample call need,
    their vocoding included."""
    from benchmark.counts.flops import row_flops

    inf = config["inference"]
    cfg_rows = 1 if config["model_class"] == "ZipVoiceDistill" else 2
    return sum(row_flops(config["model"], config["vocoder"], inf["num_step"],
                         cfg_rows, S, fl, fl - pfl)
               for S, fl, pfl in zip(rec["S"], rec["fl"], rec["pfl"]))

