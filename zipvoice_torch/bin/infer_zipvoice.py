"""Zero-shot TTS inference CLI of the PyTorch port (counterpart of
``zipvoice_tpu/bin/infer_zipvoice.py`` and of the reference
``python -m zipvoice.bin.infer_zipvoice``).

Examples:
  python -m zipvoice_torch.bin.infer_zipvoice \
      --model-dir /path/to/zipvoice  --vocoder-path /path/to/vocos.bin \
      --prompt-wav prompt.wav --prompt-text "..." \
      --text "Hello world." --res-wav-path out.wav

  python -m zipvoice_torch.bin.infer_zipvoice --model-dir DIR \
      --test-list test.tsv --res-dir results --bf16

Differences from the JAX CLI:
- ``--platform cuda|cpu`` picks the torch device and defaults to ``cuda``;
  without a CUDA device the CLI fails unless ``--platform cpu`` is given.
- there is no ``--use-pallas-attention``: the port's attention-weights
  kernel is on by default at every level whose length passes its gate.
- no download: ``--model-dir`` holds model.pt|model.safetensors,
  model.json and tokens.txt (``bin/make_model_dir.py`` writes one with
  random weights).
"""

import argparse
import logging
import os
import sys


def get_parser():
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter
    )
    parser.add_argument(
        "--model-name", type=str, default="zipvoice",
        choices=["zipvoice", "zipvoice_distill"],
    )
    parser.add_argument("--model-dir", type=str, required=True,
                        help="dir with model.pt/model.json/tokens.txt")
    parser.add_argument("--vocoder-path", type=str, default=None,
                        help="vocos pytorch_model.bin (random init if absent)")
    parser.add_argument("--prompt-wav", type=str, default=None,
                        help="required unless --test-list is given")
    parser.add_argument("--prompt-text", type=str, default=None)
    parser.add_argument("--text", type=str, default=None)
    parser.add_argument("--test-list", type=str, default=None,
                        help="tsv: wav_name\\tprompt_text\\tprompt_wav\\ttext")
    parser.add_argument("--res-wav-path", type=str, default="out.wav")
    parser.add_argument("--res-dir", type=str, default="results")
    parser.add_argument("--num-step", type=int, default=None)
    parser.add_argument("--guidance-scale", type=float, default=None)
    parser.add_argument("--speed", type=float, default=1.0)
    parser.add_argument("--t-shift", type=float, default=0.5)
    parser.add_argument("--target-rms", type=float, default=0.1)
    parser.add_argument("--max-duration", type=float, default=100.0)
    parser.add_argument("--remove-long-sil", action="store_true")
    parser.add_argument("--raw-evaluation", action="store_true",
                        help="no chunking/silence processing (benchmark sets)")
    parser.add_argument("--seed", type=int, default=666)
    parser.add_argument("--platform", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    parser.add_argument("--bf16", action="store_true",
                        help="bf16 compute (f32 norms and vocoder head)")
    return parser


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import torch

    from zipvoice_torch.frontend.audio import save_wav
    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos
    from zipvoice_torch.utils.device import resolve_device

    device = resolve_device(args.platform)
    # per-model sampling defaults (reference infer_zipvoice.py:732-741)
    if args.num_step is None:
        args.num_step = 16 if args.model_name == "zipvoice" else 8
    if args.guidance_scale is None:
        args.guidance_scale = 1.0 if args.model_name == "zipvoice" else 3.0

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model, tokenizer = load_model_dir(args.model_dir, args.model_name,
                                      dtype=dtype, device=device)
    vocoder = load_vocos(args.vocoder_path, dtype=dtype, device=device)
    pipe = InferencePipeline(model, vocoder, seed=args.seed, device=device,
                             tokenizer=tokenizer)

    jobs = []
    if args.test_list:
        with open(args.test_list) as f:
            for line in f:
                name, ptext, pwav, text = line.strip().split("\t")
                jobs.append((os.path.join(args.res_dir, name + ".wav"),
                             ptext, pwav, text))
        os.makedirs(args.res_dir, exist_ok=True)
    else:
        if args.text is None:
            raise SystemExit("--text or --test-list required")
        if not (args.prompt_wav and args.prompt_text):
            raise SystemExit(
                "--prompt-wav/--prompt-text required without --test-list"
            )
        jobs.append((args.res_wav_path, args.prompt_text, args.prompt_wav,
                     args.text))

    total_t, total_audio = 0.0, 0.0
    for save_path, prompt_text, prompt_wav, text in jobs:
        common = dict(
            prompt_text=prompt_text,
            prompt_wav_path=prompt_wav,
            text=text,
            num_step=args.num_step,
            guidance_scale=args.guidance_scale,
            speed=args.speed,
            t_shift=args.t_shift,
            target_rms=args.target_rms,
        )
        if args.raw_evaluation:
            wav, metrics = pipe.generate_raw(**common)
            metrics.setdefault("rtf_no_vocoder", metrics["rtf"])
            metrics.setdefault("rtf_vocoder", 0.0)
        else:
            wav, metrics = pipe.generate_sentence(
                **common,
                max_duration=args.max_duration,
                remove_long_sil=args.remove_long_sil,
            )
        save_wav(save_path, wav, pipe.sampling_rate)
        total_t += metrics["t"]
        total_audio += metrics["wav_seconds"]
        logging.info(
            f"{save_path}: {metrics['wav_seconds']:.2f}s audio, "
            f"rtf {metrics['rtf']:.4f} (model {metrics['rtf_no_vocoder']:.4f}"
            f" + vocoder {metrics['rtf_vocoder']:.4f})"
        )
    logging.info(
        f"total: {total_audio:.2f}s audio in {total_t:.2f}s "
        f"(rtf {total_t / max(total_audio, 1e-9):.4f})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
