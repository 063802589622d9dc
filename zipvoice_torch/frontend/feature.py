"""VocosFbank-equivalent feature extraction (counterpart of
``zipvoice_tpu/frontend/feature.py``).

24 kHz, n_fft=1024, hop=256, 100 mels, magnitude (power=1),
clamp(1e-7).log(), with lhotse's ``compute_num_frames`` frame-count
fix-up, mono or stereo (stereo -> (T, 2*100) stacked per channel).

The extraction runs with torch on the CPU by design, not as a fallback: a
prompt's fbank is per-utterance host preparation, and the JAX package pins
it to its CPU backend for the same reason, so that data workers never send
tiny per-utterance programs to the accelerator.
"""

from dataclasses import dataclass

import numpy as np
import torch

from zipvoice_torch.ops.stft import log_mel_spectrogram


@dataclass(frozen=True)
class VocosFbankConfig:
    sampling_rate: int = 24000
    n_mels: int = 100
    n_fft: int = 1024
    hop_length: int = 256


def compute_num_frames(num_samples: int, hop: int) -> int:
    """lhotse.utils.compute_num_frames for frame_shift = hop/sr:
    (num_samples + hop // 2) // hop."""
    return int((num_samples + hop // 2) // hop)


class VocosFbank:
    """Log-mel extractor matching the reference VocosFbank.

    ``extract`` accepts (n,), (1, n) or (2, n) waveforms; with num_channels=2
    a stereo input yields (T, 2*n_mels) with channels stacked feature-wise
    (reference feature.py:90-99).
    """

    def __init__(self, num_channels: int = 1):
        assert num_channels in (1, 2)
        self.num_channels = num_channels
        self.config = VocosFbankConfig()

    @property
    def frame_shift(self) -> float:
        return self.config.hop_length / self.config.sampling_rate

    def extract(self, samples: np.ndarray, sampling_rate: int) -> np.ndarray:
        """(T, C * n_mels) float32 log-mel of a waveform."""
        cfg = self.config
        assert sampling_rate == cfg.sampling_rate, (
            f"expected {cfg.sampling_rate}, got {sampling_rate}"
        )
        samples = np.asarray(samples, dtype=np.float32)
        if samples.ndim == 1:
            samples = samples[None, :]
        assert samples.ndim == 2, samples.shape

        if self.num_channels == 1:
            if samples.shape[0] == 2:
                samples = samples.mean(axis=0, keepdims=True)
        else:
            assert samples.shape[0] == 2, samples.shape

        with torch.inference_mode():
            mel = log_mel_spectrogram(
                torch.from_numpy(samples),
                n_fft=cfg.n_fft,
                hop=cfg.hop_length,
                n_mels=cfg.n_mels,
                sample_rate=cfg.sampling_rate,
            ).numpy()  # (C, T, n_mels)
        # (T, C*n_mels) matching the reference's reshape(-1, T).t()
        mel = np.concatenate([mel[c] for c in range(mel.shape[0])], axis=-1)

        num_frames = compute_num_frames(samples.shape[1], cfg.hop_length)
        if mel.shape[0] > num_frames:
            mel = mel[:num_frames]
        elif mel.shape[0] < num_frames:
            pad = num_frames - mel.shape[0]
            mel = np.concatenate(
                [mel, np.repeat(mel[-1:], pad, axis=0)], axis=0
            )
        return mel
