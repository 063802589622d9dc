"""Speaker-similarity (SIM-o) evaluation driver (the port's counterpart of
``zipvoice_tpu/eval/sim_cli.py``).

Reference zipvoice/eval/speaker_similarity/sim.py: cosine similarity of
speaker embeddings between generated wavs and their prompts, using a
WavLM-large + ECAPA-TDNN speaker verification model.

Pass --spk-model-path with a local HF speaker-verification model directory
(e.g. microsoft/wavlm-base-plus-sv, or the UniSpeech-SAT sv models); the
driver fetches nothing.  The model runs on ``--platform`` (CUDA unless
``cpu`` is asked for).

  python -m zipvoice_torch.eval.sim_cli \\
    --wav-dir results --test-list test.tsv \\
    --spk-model-path /models/wavlm-base-plus-sv
"""

import argparse
import logging
import os

import numpy as np
import torch


def load_speaker_model(model_path: str, device):
    """A function from a 16 kHz waveform (numpy) to its speaker embedding
    (numpy): the x-vector of an ``AutoModelForAudioXVector`` checkpoint, or
    else the time-mean of an ``AutoModel``'s last hidden state, computed on
    ``device``."""
    from transformers import AutoFeatureExtractor, AutoModel

    try:
        from transformers import AutoModelForAudioXVector

        model = AutoModelForAudioXVector.from_pretrained(model_path)
        use_xvector = True
    except Exception:
        model = AutoModel.from_pretrained(model_path)
        use_xvector = False
    fe = AutoFeatureExtractor.from_pretrained(model_path)
    model.to(device).eval()

    def embed(wav: np.ndarray) -> np.ndarray:
        inputs = fe(wav, sampling_rate=16000, return_tensors="pt")
        with torch.no_grad():
            out = model(**{k: v.to(device) for k, v in inputs.items()})
        if use_xvector:
            return out.embeddings[0].cpu().numpy()
        return out.last_hidden_state.mean(dim=1)[0].cpu().numpy()

    return embed


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav-dir", type=str, required=True)
    p.add_argument("--test-list", type=str, required=True,
                   help="tsv: name\\tprompt_text\\tprompt_wav\\ttext")
    p.add_argument("--spk-model-path", type=str, required=True)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--platform", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="torch device of the speaker model; without CUDA "
                        "the driver fails unless --platform cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from zipvoice_torch.eval.metrics import cosine_similarity
    from zipvoice_torch.frontend.audio import load_wav
    from zipvoice_torch.utils.device import resolve_device

    names, prompts = [], []
    with open(args.test_list) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            names.append(parts[0])
            prompts.append(parts[2])

    embed = load_speaker_model(args.spk_model_path,
                               resolve_device(args.platform))
    gen_embs = [embed(load_wav(os.path.join(args.wav_dir, n + ".wav"),
                               16000)[0]) for n in names]
    prompt_embs = [embed(load_wav(p, 16000)[0]) for p in prompts]

    sims = [
        cosine_similarity(g, p) for g, p in zip(gen_embs, prompt_embs)
    ]
    report = [f"overall SIM: {np.mean(sims):.4f}"]
    report += [f"{n}\t{s:.4f}" for n, s in zip(names, sims)]
    print("\n".join(report))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(report) + "\n")


if __name__ == "__main__":
    main()
