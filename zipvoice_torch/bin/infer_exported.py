"""Zero-shot TTS from exported sampling programs (counterpart of
``zipvoice_tpu/bin/infer_exported.py``): loads the engines that
``bin/export_model`` wrote, binds them to the model dir's weights, and runs
the prompt wav -> fbank -> smallest fitting bucket -> engine -> vocoder path
without running the model's code again (on the card, one CUDA graph
replay for the whole sample).

  python -m zipvoice_torch.bin.export_model --model-dir DIR --out-dir eng/
  python -m zipvoice_torch.bin.infer_exported \\
    --engine-dir eng --model-dir DIR --prompt-wav p.wav \\
    --prompt-text "..." --text "..." --res-wav-path out.wav

Differences from the JAX CLI: ``--platform cuda|cpu`` (default ``cuda``);
the model loads in the dtype the manifest records.
"""

import argparse
import json
import logging
import os

import numpy as np


def get_parser():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--engine-dir", type=str, required=True)
    p.add_argument("--model-dir", type=str, required=True,
                   help="for tokens.txt + model.pt weights + tokenizer")
    p.add_argument("--model-name", type=str, default="zipvoice",
                   choices=["zipvoice", "zipvoice_distill"])
    p.add_argument("--vocoder-path", type=str, default=None)
    p.add_argument("--prompt-wav", type=str, required=True)
    p.add_argument("--prompt-text", type=str, required=True)
    p.add_argument("--text", type=str, required=True)
    p.add_argument("--res-wav-path", type=str, default="out.wav")
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--target-rms", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--platform", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    return p


def pick_bucket(buckets, prompt_tokens: int, tokens: int, prompt_frames: int,
                speed: float = 1.0):
    """The first manifest bucket that fits one row (JAX's rule: the
    manifest's order, prompt and text tokens plus the trailing pad, and the
    predicted frames), and the predicted frames; raises if none fits."""
    pred = prompt_frames + int(np.ceil(prompt_frames / prompt_tokens
                                       * tokens / speed))
    for b in buckets:
        if (b["B"] >= 1 and b["S"] >= prompt_tokens + tokens + 1
                and b["T"] >= pred):
            return b, pred
    raise ValueError(f"no exported bucket fits {prompt_tokens} + {tokens} "
                     f"tokens and {pred} frames")


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from zipvoice_torch.frontend.audio import (
        load_wav,
        remove_silence,
        rms_norm,
        save_wav,
    )
    from zipvoice_torch.frontend.batch import pad_tokens
    from zipvoice_torch.frontend.feature import VocosFbank
    from zipvoice_torch.models.zipvoice import strip_prompt
    from zipvoice_torch.serving.aot import load_engine_dir
    from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos
    from zipvoice_torch.utils.device import resolve_device

    device = resolve_device(args.platform)
    with open(os.path.join(args.engine_dir, "manifest.json")) as f:
        manifest = json.load(f)
    dtype = getattr(torch, manifest["dtype"].rsplit(".", 1)[-1])
    model, tokenizer = load_model_dir(args.model_dir, args.model_name,
                                      dtype=dtype, device=device)
    vocoder = load_vocos(args.vocoder_path, dtype=dtype, device=device)
    manifest, engines = load_engine_dir(args.engine_dir, model)

    sr = 24000
    feat_scale = 0.1
    wav = load_wav(args.prompt_wav, sr)
    wav = remove_silence(wav, sr, only_edge=False, trail_sil=200)
    wav, prompt_rms = rms_norm(wav, args.target_rms)
    prompt_features = VocosFbank().extract(wav, sr) * feat_scale

    tokens = tokenizer.texts_to_token_ids([args.text])[0]
    prompt_tokens = tokenizer.texts_to_token_ids([args.prompt_text])[0]
    ptl, Tp = len(prompt_tokens), prompt_features.shape[0]
    bucket, pred = pick_bucket(manifest["buckets"], ptl, len(tokens), Tp,
                               args.speed)
    B, S, T = bucket["B"], bucket["S"], bucket["T"]

    tok, tok_lens = pad_tokens([prompt_tokens + tokens] * B,
                               pad_id=model.pad_id, pad_to=S)
    F = prompt_features.shape[1]
    pf = np.zeros((B, T, F), np.float32)
    pf[:, :Tp] = prompt_features[None]
    rng = np.random.RandomState(args.seed)
    noise = rng.randn(B, T, F).astype(np.float32)

    def dev(a, dt=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    pfl = dev(np.full((B,), Tp))
    with torch.inference_mode():
        x1, padding_mask = engines[(B, S, T)](
            dev(tok), dev(tok_lens), dev(np.full((B,), ptl)),
            dev(pf, torch.float32), pfl, dev(np.full((B,), pred)),
            dev(noise, torch.float32),
        )
        x1_wo, lens = strip_prompt(x1, padding_mask, pfl)
        n = int(lens[0])
        mel = x1_wo[:1, :n].float() / feat_scale
        wav_out = vocoder(mel.to(device)).float().cpu().numpy()[0]
    wav_out = np.clip(wav_out, -1, 1)[None, : n * 256]
    if prompt_rms < args.target_rms:
        wav_out = wav_out * prompt_rms / args.target_rms
    save_wav(args.res_wav_path, wav_out, sr)
    logging.info(
        f"{args.res_wav_path}: {wav_out.shape[-1] / sr:.2f}s "
        f"(bucket B={B} S={S} T={T}, {manifest['num_step']} steps)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
