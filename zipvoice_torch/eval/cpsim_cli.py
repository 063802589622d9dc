"""cpSIM: concatenated max-permutation speaker similarity for dialogs (the
port's counterpart of ``zipvoice_tpu/eval/cpsim_cli.py``).

Reference: zipvoice/eval/speaker_similarity/cpsim.py (pyannote diarization
+ per-speaker SIM under the best permutation).  pyannote is an external
heavyweight dependency; this driver replaces it with a self-contained
diarizer:

- stereo outputs: the channels ARE the speakers — no diarization needed
  (each channel scored against each prompt, best assignment);
- mono outputs: energy VAD -> windowed speaker embeddings -> 2-means
  clustering -> per-cluster concatenation; each cluster is embedded and
  scored against the two prompts under the best permutation.

The speaker model runs on ``--platform`` (CUDA unless ``cpu`` is asked for).

  python -m zipvoice_torch.eval.cpsim_cli --wav-dir results \\
    --test-list dialog_test.tsv --spk-model-path /models/wavlm-sv \\
    [--stereo]
"""

import argparse
import logging
import os
from itertools import permutations
from typing import List

import numpy as np


def energy_vad(wav: np.ndarray, sr: int, win_ms: float = 30.0,
               thresh_db: float = -45.0):
    """Boolean speech mask per window + segment list [(start, end) samples]."""
    win = int(sr * win_ms / 1000)
    n = len(wav) // win
    frames = wav[: n * win].reshape(n, win)
    rms = np.sqrt(np.mean(frames ** 2, axis=1) + 1e-12)
    db = 20 * np.log10(rms + 1e-12)
    speech = db > thresh_db
    segments = []
    start = None
    for i, s in enumerate(speech):
        if s and start is None:
            start = i
        elif not s and start is not None:
            segments.append((start * win, i * win))
            start = None
    if start is not None:
        segments.append((start * win, n * win))
    return speech, segments


def kmeans2(X: np.ndarray, iters: int = 50, seed: int = 0):
    """2-means over rows of X; returns labels."""
    rng = np.random.RandomState(seed)
    Xn = X / (np.linalg.norm(X, axis=1, keepdims=True) + 1e-9)
    # farthest-pair init
    c0 = Xn[rng.randint(len(Xn))]
    d = Xn @ c0
    c1 = Xn[np.argmin(d)]
    centers = np.stack([c0, c1])
    labels = np.zeros(len(Xn), np.int32)
    for _ in range(iters):
        sims = Xn @ centers.T
        new = np.argmax(sims, axis=1)
        if (new == labels).all():
            break
        labels = new
        for k in (0, 1):
            if (labels == k).any():
                c = Xn[labels == k].mean(axis=0)
                centers[k] = c / (np.linalg.norm(c) + 1e-9)
    return labels


def diarize_two(wav: np.ndarray, sr: int, embed_fn, chunk_s: float = 1.5):
    """Mono waveform -> two per-speaker concatenated waveforms."""
    _, segments = energy_vad(wav, sr)
    chunks, spans = [], []
    step = int(chunk_s * sr)
    for s, e in segments:
        for c in range(s, e, step):
            span = (c, min(c + step, e))
            if span[1] - span[0] > sr // 4:
                chunks.append(wav[span[0]: span[1]])
                spans.append(span)
    if len(chunks) < 2:
        return wav, wav
    embs = np.stack([embed_fn(c) for c in chunks])
    labels = kmeans2(embs)
    a = np.concatenate([c for c, l in zip(chunks, labels) if l == 0] or [wav])
    b = np.concatenate([c for c, l in zip(chunks, labels) if l == 1] or [wav])
    return a, b


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav-dir", type=str, required=True)
    p.add_argument("--test-list", type=str, required=True,
                   help="tsv: name\\tprompt_text\\tprompt_wav_spk1,"
                        "prompt_wav_spk2\\ttext")
    p.add_argument("--spk-model-path", type=str, required=True)
    p.add_argument("--stereo", action="store_true")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--platform", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="torch device of the speaker model; without CUDA "
                        "the driver fails unless --platform cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from zipvoice_torch.eval.metrics import cosine_similarity
    from zipvoice_torch.eval.sim_cli import load_speaker_model
    from zipvoice_torch.frontend.audio import load_wav
    from zipvoice_torch.utils.device import resolve_device

    embed = load_speaker_model(args.spk_model_path,
                               resolve_device(args.platform))

    rows: List = []
    with open(args.test_list) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            rows.append((parts[0], parts[2].split(",")))

    sims = []
    for name, prompt_paths in rows:
        gen = load_wav(os.path.join(args.wav_dir, name + ".wav"), 16000)
        prompts = [load_wav(pp, 16000)[0] for pp in prompt_paths[:2]]
        prompt_embs = [embed(pw) for pw in prompts]
        if args.stereo and gen.shape[0] == 2:
            spk_wavs = [gen[0], gen[1]]
        else:
            spk_wavs = list(diarize_two(gen.mean(axis=0), 16000, embed))
        gen_embs = [embed(w) for w in spk_wavs]
        best = max(
            np.mean([
                cosine_similarity(gen_embs[i], prompt_embs[j])
                for i, j in enumerate(perm)
            ])
            for perm in permutations(range(len(prompt_embs)))
        )
        sims.append(best)
        logging.info(f"{name}: cpSIM {best:.4f}")

    report = [f"overall cpSIM: {np.mean(sims):.4f}"]
    report += [f"{r[0]}\t{s:.4f}" for r, s in zip(rows, sims)]
    print("\n".join(report))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(report) + "\n")


if __name__ == "__main__":
    main()
