"""The full-width training workload that checks and times the port on a card.

``chip_smoke.py`` and ``torch_train_probe.py`` both drive it: the ZipVoice
base model (vocab 360) with random weights from a seed, f32 parameters and
bf16 compute, ScaledAdam with Eden (base rate 0.02) and clipping at 2x, the
batch-count schedules on (250 s batches) with scheduled dropout, and a
synthetic B=8, S=128, T=1280 batch, as ``train_probe.py`` runs the JAX
package.
"""

import numpy as np
import torch

from zipvoice_torch.models.zipvoice import build_zipvoice
from zipvoice_torch.train.optim import ScaledAdam, eden_schedule
from zipvoice_torch.train.train_step import make_train_step


def train_batch(seed: int, B: int = 8, S: int = 128, T: int = 1280,
                feat_dim: int = 100, vocab: int = 360, device="cuda"):
    """Tokens of S-1 ids plus the trailing pad, 0.3-scaled gaussian
    features, frame lengths drawn in [T/2, T] with row 0 full."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(T // 2, T + 1, B)
    lens[0] = T
    tokens = rng.randint(1, vocab - 60, (B, S))
    tokens[:, -1] = 0
    batch = dict(
        tokens=tokens, tokens_lens=np.full((B,), S - 1),
        features=(0.3 * rng.randn(B, T, feat_dim)).astype(np.float32),
        features_lens=lens,
    )
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items()}


def build_trainer(seed: int, dtype: torch.dtype = torch.bfloat16,
                  device="cuda", kernel_config: bool = False):
    """(model, optimizer, train_step) for the ZipVoice base at full width;
    with ``kernel_config`` every kernel is on (in training that adds the
    depthwise-conv pair to the attention pair)."""
    model = build_zipvoice(vocab_size=360, dtype=dtype, seed=seed,
                           train=True, device=device,
                           kernel_config=kernel_config)
    opt = ScaledAdam(model.parameters(), lr=eden_schedule(base_lr=0.02),
                     clipping_scale=2.0)
    step = make_train_step(model, opt, dropout_rate=None, schedules=True,
                           max_duration=250.0, seed=seed)
    return model, opt, step
