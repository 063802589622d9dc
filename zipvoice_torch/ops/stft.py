"""STFT, mel filterbank and inverse STFT (counterpart of
``zipvoice_tpu/ops/stft.py``).

The forward direction is the fbank's: ``torch.stft`` with center reflect
padding and a periodic Hann window, the magnitude, then the HTK mel
filterbank (torchaudio's ``melscale_fbanks`` with no norm, built in f64
numpy as the JAX package builds it) as a matmul, ``clamp(1e-7)`` and
``log``.  The inverse is the Vocos head's, with torch.istft's
center-trimming semantics."""

import math

import numpy as np
import torch


def hann_window(win_length: int) -> np.ndarray:
    """torch.hann_window(periodic=True), computed in f64, stored f32."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * n / win_length)).astype(
        np.float32
    )


def melscale_fbanks(n_freqs: int, n_mels: int, sample_rate: int,
                    f_min: float = 0.0, f_max: float = None) -> np.ndarray:
    """HTK-scale triangular mel filterbank, (n_freqs, n_mels) f32, as
    torchaudio.functional.melscale_fbanks(norm=None, mel_scale='htk')."""
    if f_max is None:
        f_max = sample_rate / 2.0

    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0)
                        - 1.0)

    all_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)
    f_diff = np.diff(f_pts)  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down_slopes = -slopes[:, :-2] / f_diff[:-1]
    up_slopes = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.astype(np.float32)


def stft_magnitude(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """|STFT| with center reflect padding and a periodic Hann window:
    (..., n) -> (..., n // hop + 1, n_fft // 2 + 1)."""
    lead = x.shape[:-1]
    window = torch.from_numpy(hann_window(n_fft)).to(x.device)
    spec = torch.stft(x.reshape(-1, x.shape[-1]), n_fft=n_fft,
                      hop_length=hop, win_length=n_fft, window=window,
                      center=True, pad_mode="reflect", onesided=True,
                      return_complex=True)
    return spec.abs().transpose(-1, -2).reshape(*lead, -1, n_fft // 2 + 1)


def log_mel_spectrogram(x: torch.Tensor, n_fft: int = 1024, hop: int = 256,
                        n_mels: int = 100, sample_rate: int = 24000
                        ) -> torch.Tensor:
    """The Vocos fbank's log-mel: magnitude STFT, HTK mel matmul,
    clamp(1e-7), log.  x: (..., n) -> (..., n // hop + 1, n_mels)."""
    mag = stft_magnitude(x, n_fft, hop)
    fb = torch.from_numpy(
        melscale_fbanks(n_fft // 2 + 1, n_mels, sample_rate)
    ).to(mag.device)
    return torch.log(torch.clamp(mag @ fb, min=1e-7))


def overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """(..., T, L) frames with hop | L -> (..., (T-1)*hop + L) signal.

    Each frame is cut into r = L // hop hop-sized pieces; piece j of frame
    t lands on output chunk t + j.
    """
    *lead, T, L = frames.shape
    r = L // hop
    if r * hop != L:
        raise ValueError(f"hop {hop} does not divide frame length {L}")
    chunks = frames.reshape(*lead, T, r, hop)
    acc = frames.new_zeros((*lead, T + r - 1, hop))
    for j in range(r):
        acc[..., j:j + T, :] += chunks[..., :, j, :]
    return acc.reshape(*lead, (T + r - 1) * hop)


def istft(spec_real: torch.Tensor, spec_imag: torch.Tensor,
          n_fft: int = 1024, hop: int = 256, length: int = None
          ) -> torch.Tensor:
    """Inverse STFT, hann window, center trimming; spec_*: (..., T,
    n_fft//2 + 1) -> waveform (..., length)."""
    frames = torch.fft.irfft(torch.complex(spec_real, spec_imag), n=n_fft,
                             dim=-1)
    window = torch.from_numpy(hann_window(n_fft)).to(frames.device)
    y = overlap_add(frames * window, hop)
    T = spec_real.shape[-2]
    envelope = overlap_add((window * window).expand(T, n_fft), hop)
    y = y / envelope.clamp(min=1e-11)
    pad = n_fft // 2
    y = y[..., pad:]
    if length is not None:
        return y[..., :length]
    return y[..., : y.shape[-1] - pad]
