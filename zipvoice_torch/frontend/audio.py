"""Host-side audio utilities: silence removal, RMS norm, cross-fade, resample
(the port's copy of ``zipvoice_tpu/frontend/audio.py``, numpy only).

The reference does this with pydub/ffmpeg (reference zipvoice/utils/infer.py:
262-414) — an external C dependency.  Here it is pure numpy implementing the
same algorithms on the same int16-quantized representation pydub uses, so the
trim points match:

- dBFS of a window = 20*log10(rms / 32768) over interleaved int16 samples;
- detect_leading_silence walks 10 ms chunks until one is >= the threshold;
- split_on_silence finds windows of >= min_silence_len whose rms is below
  threshold (stepped by seek_step), merges them, keeps keep_silence ms at
  the edges of the surviving segments.

Waveforms are float arrays shaped (C, T) in [-1, 1].
"""

from typing import List, Tuple

import numpy as np


def _to_int16(audio: np.ndarray) -> np.ndarray:
    return (
        (np.asarray(audio, np.float32) * 32768.0).clip(-32768, 32767).astype(np.int16)
    )


def _rms_int(x: np.ndarray) -> float:
    """audioop.rms equivalent on int16 amplitude scale.  Accepts float
    waveforms in [-1, 1] (integer sqrt truncation skipped; it is < 1 LSB and
    does not move -50 dBFS decisions)."""
    if x.size == 0:
        return 0.0
    return float(
        np.sqrt(np.mean(np.square(x.astype(np.float64) * 32768.0)))
    )


def _db_to_amp(db: float) -> float:
    return 10.0 ** (db / 20.0) * 32768.0


def detect_leading_silence(
    x: np.ndarray, sr: int, silence_threshold: float = -50.0, chunk_ms: int = 10
) -> int:
    """Leading-silence length in ms (pydub.silence.detect_leading_silence)."""
    chunk = int(sr * chunk_ms / 1000)
    thresh_amp = _db_to_amp(silence_threshold)
    n_ms = x.shape[-1] * 1000 // sr
    trim_ms = 0
    while trim_ms < n_ms:
        s = trim_ms * sr // 1000
        if _rms_int(x[..., s : s + chunk]) >= thresh_amp:
            break
        trim_ms += chunk_ms
    return trim_ms


def detect_silence(
    x: np.ndarray,
    sr: int,
    min_silence_len: int = 1000,
    silence_thresh: float = -50.0,
    seek_step: int = 10,
) -> List[Tuple[int, int]]:
    """Silent [start_ms, end_ms) ranges (pydub.silence.detect_silence)."""
    seg_len = x.shape[-1] * 1000 // sr
    if seg_len < min_silence_len:
        return []
    thresh_amp = _db_to_amp(silence_thresh)
    last_slice_start = seg_len - min_silence_len
    slice_starts = list(range(0, last_slice_start + 1, seek_step))
    if last_slice_start % seek_step:
        slice_starts.append(last_slice_start)

    silent_starts = []
    for i in slice_starts:
        s = i * sr // 1000
        e = (i + min_silence_len) * sr // 1000
        if _rms_int(x[..., s:e]) <= thresh_amp:
            silent_starts.append(i)

    if not silent_starts:
        return []
    ranges = []
    prev_i = silent_starts[0]
    current_range_start = prev_i
    for i in silent_starts[1:]:
        if i - prev_i > seek_step:  # new silent range
            ranges.append((current_range_start, prev_i + min_silence_len))
            current_range_start = i
        prev_i = i
    ranges.append((current_range_start, prev_i + min_silence_len))
    return ranges


def detect_nonsilent(x, sr, min_silence_len=1000, silence_thresh=-50.0,
                     seek_step=10) -> List[Tuple[int, int]]:
    seg_len = x.shape[-1] * 1000 // sr
    silent = detect_silence(x, sr, min_silence_len, silence_thresh, seek_step)
    if not silent:
        return [(0, seg_len)]
    if silent == [(0, seg_len)]:
        return []
    out = []
    prev_end = 0
    for s, e in silent:
        if s > prev_end:
            out.append((prev_end, s))
        prev_end = e
    if prev_end < seg_len:
        out.append((prev_end, seg_len))
    if out and out[0] == (0, 0):
        out.pop(0)
    return out


def _ms_slice(x: np.ndarray, sr: int, start_ms: int, end_ms: int) -> np.ndarray:
    return x[..., max(0, start_ms * sr // 1000) : end_ms * sr // 1000]


def remove_silence(
    audio: np.ndarray,
    sr: int,
    only_edge: bool = False,
    trail_sil: float = 0.0,
) -> np.ndarray:
    """Reference remove_silence (utils/infer.py:281-325): drop interior
    silences > 1 s (keeping 1 s around segments), trim edge silences to
    100 ms, append ``trail_sil`` ms of silence."""
    x = _to_int16(audio).astype(np.float32) / 32768.0
    if x.ndim == 1:
        x = x[None]

    if not only_edge:
        seg_len = x.shape[-1] * 1000 // sr
        nonsilent = detect_nonsilent(
            x, sr, min_silence_len=1000, silence_thresh=-50.0, seek_step=10
        )
        keep = 1000
        ranges = [[s - keep, e + keep] for s, e in nonsilent]
        for i in range(len(ranges) - 1):
            if ranges[i][1] > ranges[i + 1][0]:
                mid = (ranges[i][1] + ranges[i + 1][0]) // 2
                ranges[i][1] = mid
                ranges[i + 1][0] = mid
        pieces = [
            _ms_slice(x, sr, max(0, s), min(seg_len, e)) for s, e in ranges
        ]
        x = (
            np.concatenate(pieces, axis=-1)
            if pieces
            else np.zeros_like(x[..., :0])
        )

    # edge trimming, keeping 100 ms (utils/infer.py:328-355)
    lead = max(0, detect_leading_silence(x, sr) - 100)
    x = x[..., lead * sr // 1000 :]
    rev = x[..., ::-1]
    trail = max(0, detect_leading_silence(rev, sr) - 100)
    if trail > 0:
        x = x[..., : -(trail * sr // 1000) or None]

    if trail_sil > 0:
        pad = np.zeros((x.shape[0], int(trail_sil * sr / 1000)), x.dtype)
        x = np.concatenate([x, pad], axis=-1)
    return x


def rms_norm(wav: np.ndarray, target_rms: float = 0.1):
    """Boost quiet prompts to target rms; returns (wav, original_rms)
    (reference utils/infer.py:262-278)."""
    rms = float(np.sqrt(np.mean(np.square(wav))))
    if rms < target_rms and rms > 0:
        wav = wav * (target_rms / rms)
    return wav, rms


def cross_fade_concat(
    chunks: List[np.ndarray], fade_duration: float = 0.1, sample_rate: int = 24000
) -> np.ndarray:
    """Linear cross-fade concatenation (reference utils/infer.py:173-229)."""
    if len(chunks) <= 1:
        return chunks[0] if chunks else np.zeros((1, 0), np.float32)
    fade_samples = int(fade_duration * sample_rate)
    if fade_samples <= 0:
        return np.concatenate(chunks, axis=-1)
    final = chunks[0]
    for nxt in chunks[1:]:
        k = min(fade_samples, final.shape[-1], nxt.shape[-1])
        if k <= 0:
            final = np.concatenate([final, nxt], axis=-1)
            continue
        fade = np.linspace(1.0, 0.0, k, dtype=final.dtype)[None]
        final = np.concatenate(
            [
                final[..., :-k],
                final[..., -k:] * fade + nxt[..., :k] * (1 - fade),
                nxt[..., k:],
            ],
            axis=-1,
        )
    return final


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase sinc resampling (replaces torchaudio.transforms.Resample)."""
    if orig_sr == target_sr:
        return wav
    from math import gcd

    g = gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    from scipy.signal import resample_poly  # scipy ships with the image

    return resample_poly(wav, up, down, axis=-1).astype(np.float32)


def load_wav(path: str, target_sr: int) -> np.ndarray:
    """Load a wav/flac file to (C, T) float32 at target_sr (soundfile or
    stdlib wave fallback)."""
    try:
        import soundfile as sf

        data, sr = sf.read(path, dtype="float32", always_2d=True)
        wav = data.T  # (C, T)
    except ImportError:
        import wave as wave_mod

        with wave_mod.open(path, "rb") as f:
            sr = f.getframerate()
            n = f.getnframes()
            ch = f.getnchannels()
            width = f.getsampwidth()
            raw = f.readframes(n)
        assert width == 2, "only 16-bit wav supported without soundfile"
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        wav = data.reshape(-1, ch).T
    return resample(wav, sr, target_sr)


def save_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """Save (C, T) float32 to a 16-bit wav."""
    try:
        import soundfile as sf

        sf.write(path, np.asarray(wav).T, sr)
        return
    except ImportError:
        pass
    import wave as wave_mod

    x = _to_int16(wav)
    if x.ndim == 1:
        x = x[None]
    with wave_mod.open(path, "wb") as f:
        f.setnchannels(x.shape[0])
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(x.T.tobytes())
