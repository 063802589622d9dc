"""Full-width requests that check and time the port on a card.

``chip_smoke.py`` and ``torch_main_path_probe.py`` both drive these: the
ZipVoice base model and the Vocos mel-24khz vocoder at their published
widths, with random weights from a seed, and three micro-batch requests
through the pipeline's batch path.
"""

import subprocess

import numpy as np
import torch

from zipvoice_torch.models.zipvoice import build_zipvoice
from zipvoice_torch.vocoder.vocos import build_vocos


def card_identity() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def build_base(seed: int, dtype: torch.dtype = torch.bfloat16,
               device="cuda"):
    """(ZipVoice base, Vocos mel-24khz) at full width, random weights."""
    model = build_zipvoice(vocab_size=360, dtype=dtype, seed=seed,
                           device=device)
    vocos = build_vocos(dtype=dtype, seed=seed + 1, device=device)
    return model, vocos


def micro_batches(feat_dim: int, seed: int):
    """Three micro-batches: B=1 at the 512-frame bucket, B=4 with four
    prompts and speeds at 1024, B=8 at 1280 (3 s prompts, 100-token texts:
    the bench.py shape)."""
    rng = np.random.RandomState(seed)

    def toks(n):
        return [int(t) for t in rng.randint(3, 300, n)]

    def feats(n):
        return (0.5 * rng.randn(n, feat_dim)).astype(np.float32)

    p3s = toks(30), feats(281)
    return [
        dict(texts=[toks(40)], prompt_tokens=toks(20),
             prompt_features=feats(150), speed=1.0),
        dict(texts=[toks(60) for _ in range(4)],
             prompt_tokens=[toks(n) for n in (20, 25, 15, 30)],
             prompt_features=[feats(n) for n in (200, 250, 180, 220)],
             speed=[1.0, 0.9, 1.1, 1.2]),
        dict(texts=[toks(100) for _ in range(8)], prompt_tokens=p3s[0],
             prompt_features=p3s[1], speed=1.0),
    ]


def sample(pipe, req, num_step: int):
    """One request's features (B, T, F) and generated lengths (B,)."""
    return pipe._sample_batch(
        req["texts"], req["prompt_tokens"], req["prompt_features"],
        num_step=num_step, guidance_scale=1.0, speed=req["speed"],
        t_shift=0.5,
    )


def run_request(pipe, req, num_step: int):
    """Sample one request, then vocode each row: (feats, lens, wavs)."""
    feats, lens = sample(pipe, req, num_step)
    wavs = pipe._vocode_chunks([feats[i, :n] for i, n in enumerate(lens)])
    return feats, lens, wavs


def speech_like_wav(seed: int, seconds: float = 3.0, sr: int = 24000,
                    amplitude: float = 0.08, edge_silence: float = 0.3
                    ) -> np.ndarray:
    """A (1, n) prompt waveform made from ``seed``: a harmonic voice at a
    gliding pitch with syllable-rate amplitude modulation and a low noise
    floor, with ``edge_silence`` s of silence at each end.  At the default
    amplitude its rms is below 0.1, so the pipeline's ``rms_norm`` raises
    it, and its silent edges are long enough for ``remove_silence`` to
    cut."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    f0 = 120.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6.3))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voice = sum(rng.uniform(0.3, 1.0) / h * np.sin(h * phase)
                for h in range(1, 6))
    envelope = np.clip(np.sin(2 * np.pi * 4.0 * t + rng.uniform(0, 6.3)),
                       0.05, None)
    x = amplitude * voice * envelope + 0.001 * rng.randn(len(t))
    edge = int(edge_silence * sr)
    x[:edge] = 0.0
    x[len(x) - edge:] = 0.0
    return x.astype(np.float32)[None]
