"""Synthetic prompt speech and 16-bit WAV files, frozen with the benchmark.

``speech_like_wav`` is a copy of the port's ``infer/workload.py`` function
of that name, kept here so that a change to the program cannot move the
prompts the benchmark feeds it.
"""

import io
import wave

import numpy as np


def speech_like_wav(seed: int, seconds: float = 3.0, sr: int = 24000,
                    amplitude: float = 0.08, edge_silence: float = 0.3
                    ) -> np.ndarray:
    """A (1, n) prompt waveform made from ``seed``: a harmonic voice at a
    gliding pitch with syllable-rate amplitude modulation and a low noise
    floor, with ``edge_silence`` s of silence at each end."""
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


def to_int16(wav: np.ndarray) -> np.ndarray:
    """A float waveform in [-1, 1] as 16-bit samples."""
    return (np.clip(np.asarray(wav, np.float32), -1.0, 1.0)
            * 32767).astype(np.int16)


def wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    """A mono (1, n) or (n,) float waveform as the bytes of a 16-bit WAV."""
    x = to_int16(np.asarray(wav).reshape(-1))
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(x.tobytes())
    return buf.getvalue()


def read_wav_bytes(raw: bytes):
    """(float32 (C, n) waveform in [-1, 1), sample rate) of WAV bytes."""
    with wave.open(io.BytesIO(raw), "rb") as f:
        sr = f.getframerate()
        ch = f.getnchannels()
        data = np.frombuffer(f.readframes(f.getnframes()), np.int16)
    return (data.astype(np.float32) / 32768.0).reshape(-1, ch).T, sr
