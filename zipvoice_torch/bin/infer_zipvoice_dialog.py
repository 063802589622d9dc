"""Dialogue TTS inference CLI of the PyTorch port, mono and stereo
(counterpart of ``zipvoice_tpu/bin/infer_zipvoice_dialog.py`` and of the
reference ``python -m zipvoice.bin.infer_zipvoice_dialog``).

Mono (ZipVoice-Dialog):
  python -m zipvoice_torch.bin.infer_zipvoice_dialog \\
      --model-name zipvoice_dialog --model-dir DIR --vocoder-path VOCOS \\
      --prompt-text-1 "..." --prompt-wav-1 a.wav \\
      --prompt-text-2 "..." --prompt-wav-2 b.wav \\
      --text "[S1] Hi there. [S2] Hello!" --res-wav-path out.wav

Stereo (ZipVoice-Dialog-Stereo): ``--model-name zipvoice_dialog_stereo``;
the two prompts land on separate channels and the wav has two.  A single
merged prompt (its text with [S1]/[S2] turns, and one wav, stereo for the
stereo model) goes in ``--prompt-text-1``/``--prompt-wav-1`` with
``--merged-prompt``.  ``--test-list`` rows are
``name\\tptext1\\tptext2\\tpwav1\\tpwav2\\ttext`` (split prompts) or
``name\\tptext\\tpwav\\ttext`` (a merged prompt).

Differences from the JAX CLI:
- ``--platform cuda|cpu`` picks the torch device and defaults to ``cuda``;
  without a CUDA device the CLI fails unless ``--platform cpu`` is given.
- there is no ``--use-pallas-attention``: the port's attention-weights
  kernel is on by default at every level whose length passes its gate.
- no download: ``--model-dir`` holds model.pt|model.safetensors,
  model.json and tokens.txt with [S1] and [S2] (``bin/make_model_dir.py
  --model-name zipvoice_dialog[_stereo]`` writes one with random weights).
"""

import argparse
import logging
import os
import sys


def get_parser():
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter
    )
    p.add_argument("--model-name", type=str, default="zipvoice_dialog",
                   choices=["zipvoice_dialog", "zipvoice_dialog_stereo"])
    p.add_argument("--model-dir", type=str, required=True,
                   help="dir with model.pt/model.json/tokens.txt")
    p.add_argument("--vocoder-path", type=str, default=None,
                   help="vocos pytorch_model.bin (random init if absent)")
    p.add_argument("--prompt-text-1", type=str, default=None)
    p.add_argument("--prompt-wav-1", type=str, default=None)
    p.add_argument("--prompt-text-2", type=str, default=None)
    p.add_argument("--prompt-wav-2", type=str, default=None)
    p.add_argument("--merged-prompt", action="store_true",
                   help="prompt-1 is a pre-merged [S1]..[S2].. prompt")
    p.add_argument("--text", type=str, default=None)
    p.add_argument("--test-list", type=str, default=None,
                   help="tsv rows: name\\tptext\\tpwav\\ttext (merged prompt) "
                        "or name\\tptext1\\tptext2\\tpwav1\\tpwav2\\ttext")
    p.add_argument("--res-dir", type=str, default="results")
    p.add_argument("--res-wav-path", type=str, default="out.wav")
    p.add_argument("--num-step", type=int, default=16)
    p.add_argument("--guidance-scale", type=float, default=1.5)
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--t-shift", type=float, default=0.5)
    p.add_argument("--target-rms", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--platform", type=str, default="cuda",
                   choices=["cuda", "cpu"])
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (f32 norms and vocoder head)")
    return p


def read_test_list(path: str, res_dir: str):
    """(save path, prompt text(s), prompt wav(s), text) of each row: six
    fields for split prompts, four for a merged one."""
    jobs = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            items = line.strip().split("\t")
            if len(items) == 6:
                name, pt1, pt2, pw1, pw2, text = items
                jobs.append((os.path.join(res_dir, name + ".wav"),
                             [pt1, pt2], [pw1, pw2], text))
            elif len(items) == 4:
                name, pt, pw, text = items
                jobs.append((os.path.join(res_dir, name + ".wav"), pt, pw,
                             text))
            else:
                raise ValueError(f"invalid test-list line: {line!r}")
    return jobs


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from zipvoice_torch.frontend.audio import save_wav
    from zipvoice_torch.infer.dialog_pipeline import (
        DialogInferencePipeline,
        StereoDialogInferencePipeline,
    )
    from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos
    from zipvoice_torch.utils.device import resolve_device

    device = resolve_device(args.platform)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model, tokenizer = load_model_dir(args.model_dir, args.model_name,
                                      dtype=dtype, device=device)
    vocoder = load_vocos(args.vocoder_path, dtype=dtype, device=device)

    if args.test_list:
        jobs = read_test_list(args.test_list, args.res_dir)
        os.makedirs(args.res_dir, exist_ok=True)
    else:
        if args.text is None:
            raise SystemExit("--text or --test-list required")
        if not (args.prompt_wav_1 and args.prompt_text_1):
            raise SystemExit(
                "--prompt-wav-1/--prompt-text-1 required without --test-list"
            )
        if args.merged_prompt or args.prompt_wav_2 is None:
            prompt_text, prompt_wav = args.prompt_text_1, args.prompt_wav_1
        else:
            prompt_text = [args.prompt_text_1, args.prompt_text_2]
            prompt_wav = [args.prompt_wav_1, args.prompt_wav_2]
        jobs = [(args.res_wav_path, prompt_text, prompt_wav, args.text)]

    if args.model_name == "zipvoice_dialog_stereo":
        pipe = StereoDialogInferencePipeline(
            model, vocoder, seed=args.seed, device=device, tokenizer=tokenizer
        )
        generate = pipe.generate_dialog_stereo
    else:
        pipe = DialogInferencePipeline(
            model, vocoder, seed=args.seed, device=device, tokenizer=tokenizer
        )
        generate = pipe.generate_dialog

    total_t, total_audio = 0.0, 0.0
    for save_path, prompt_text, prompt_wav, text in jobs:
        wav, metrics = generate(
            prompt_text=prompt_text,
            prompt_wav_path=prompt_wav,
            text=text,
            num_step=args.num_step,
            guidance_scale=args.guidance_scale,
            speed=args.speed,
            t_shift=args.t_shift,
            target_rms=args.target_rms,
        )
        save_wav(save_path, wav, pipe.sampling_rate)
        total_t += metrics["t"]
        total_audio += metrics["wav_seconds"]
        logging.info(
            f"{save_path}: {metrics['wav_seconds']:.2f}s audio, "
            f"{wav.shape[0]} channel(s), rtf {metrics['rtf']:.4f} "
            f"(vocoder {metrics['t_vocoder']:.4f}s)"
        )
    logging.info(
        f"total: {total_audio:.2f}s audio in {total_t:.2f}s "
        f"(rtf {total_t / max(total_audio, 1e-9):.4f})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
