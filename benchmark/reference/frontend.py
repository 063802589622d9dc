"""The plain reference's host side: prompt preparation, text chunking and
batch packing, length buckets, noise, and the output's merging and trim.

Frozen copies of the algorithms of the port's ``frontend/`` (which follow
the upstream ZipVoice's ``utils/infer.py`` and lhotse's ``VocosFbank``), in
numpy and plain torch on the CPU.  Nothing of the program is imported.
"""

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

SR = 24000
HOP = 256
N_FFT = 1024
N_MELS = 100
TOKEN_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512, 768)
FRAME_BUCKETS = (128, 256, 384, 512, 768, 1024, 1280, 1536, 2048, 2560, 3072)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
PUNCTUATION = {";", ":", ",", ".", "!", "?", "；", "：", "，", "。", "！", "？"}


def bucket_length(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"length {n} exceeds the largest bucket {buckets[-1]}")


# --- audio (pydub's algorithms on int16 samples) -------------------------

def _to_int16(audio: np.ndarray) -> np.ndarray:
    return (np.asarray(audio, np.float32) * 32768.0).clip(
        -32768, 32767).astype(np.int16)


def _rms_int(x: np.ndarray) -> float:
    if x.size == 0:
        return 0.0
    return float(np.sqrt(np.mean(np.square(x.astype(np.float64) * 32768.0))))


def _db_to_amp(db: float) -> float:
    return 10.0 ** (db / 20.0) * 32768.0


def leading_silence_ms(x: np.ndarray, sr: int, threshold: float = -50.0,
                       chunk_ms: int = 10) -> int:
    chunk = int(sr * chunk_ms / 1000)
    thresh = _db_to_amp(threshold)
    n_ms = x.shape[-1] * 1000 // sr
    trim = 0
    while trim < n_ms:
        s = trim * sr // 1000
        if _rms_int(x[..., s:s + chunk]) >= thresh:
            break
        trim += chunk_ms
    return trim


def _silent_ranges(x, sr, min_len=1000, thresh_db=-50.0, step=10):
    seg_len = x.shape[-1] * 1000 // sr
    if seg_len < min_len:
        return []
    thresh = _db_to_amp(thresh_db)
    last = seg_len - min_len
    starts = list(range(0, last + 1, step))
    if last % step:
        starts.append(last)
    silent = [i for i in starts
              if _rms_int(x[..., i * sr // 1000:(i + min_len) * sr // 1000])
              <= thresh]
    if not silent:
        return []
    ranges, prev, begin = [], silent[0], silent[0]
    for i in silent[1:]:
        if i - prev > step:
            ranges.append((begin, prev + min_len))
            begin = i
        prev = i
    ranges.append((begin, prev + min_len))
    return ranges


def _nonsilent_ranges(x, sr):
    seg_len = x.shape[-1] * 1000 // sr
    silent = _silent_ranges(x, sr)
    if not silent:
        return [(0, seg_len)]
    if silent == [(0, seg_len)]:
        return []
    out, prev_end = [], 0
    for s, e in silent:
        if s > prev_end:
            out.append((prev_end, s))
        prev_end = e
    if prev_end < seg_len:
        out.append((prev_end, seg_len))
    if out and out[0] == (0, 0):
        out.pop(0)
    return out


def remove_silence(audio: np.ndarray, sr: int, only_edge: bool = False,
                   trail_sil: float = 0.0) -> np.ndarray:
    """Interior silences over 1 s cut to 1 s around the speech (unless
    ``only_edge``), edge silences trimmed to 100 ms, ``trail_sil`` ms of
    silence appended; on the int16-quantized waveform."""
    x = _to_int16(audio).astype(np.float32) / 32768.0
    if x.ndim == 1:
        x = x[None]
    if not only_edge:
        seg_len = x.shape[-1] * 1000 // sr
        ranges = [[s - 1000, e + 1000] for s, e in _nonsilent_ranges(x, sr)]
        for i in range(len(ranges) - 1):
            if ranges[i][1] > ranges[i + 1][0]:
                mid = (ranges[i][1] + ranges[i + 1][0]) // 2
                ranges[i][1] = ranges[i + 1][0] = mid
        pieces = [x[..., max(0, max(0, s) * sr // 1000):
                    min(seg_len, e) * sr // 1000] for s, e in ranges]
        x = (np.concatenate(pieces, axis=-1) if pieces
             else np.zeros_like(x[..., :0]))
    lead = max(0, leading_silence_ms(x, sr) - 100)
    x = x[..., lead * sr // 1000:]
    trail = max(0, leading_silence_ms(x[..., ::-1], sr) - 100)
    if trail > 0:
        x = x[..., :-(trail * sr // 1000) or None]
    if trail_sil > 0:
        x = np.concatenate(
            [x, np.zeros((x.shape[0], int(trail_sil * sr / 1000)), x.dtype)],
            axis=-1)
    return x


def rms_norm(wav: np.ndarray, target: float = 0.1):
    rms = float(np.sqrt(np.mean(np.square(wav))))
    if 0 < rms < target:
        wav = wav * (target / rms)
    return wav, rms


def cross_fade_concat(chunks: List[np.ndarray], fade_s: float = 0.1,
                      sr: int = SR) -> np.ndarray:
    if len(chunks) <= 1:
        return chunks[0] if chunks else np.zeros((1, 0), np.float32)
    n = int(fade_s * sr)
    out = chunks[0]
    for nxt in chunks[1:]:
        k = min(n, out.shape[-1], nxt.shape[-1])
        if k <= 0:
            out = np.concatenate([out, nxt], axis=-1)
            continue
        fade = np.linspace(1.0, 0.0, k, dtype=out.dtype)[None]
        out = np.concatenate([out[..., :-k],
                              out[..., -k:] * fade + nxt[..., :k] * (1 - fade),
                              nxt[..., k:]], axis=-1)
    return out


# --- log-mel features -----------------------------------------------------

def hann(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * math.pi * i / n)).astype(np.float32)


def mel_filters(n_freqs: int = N_FFT // 2 + 1, n_mels: int = N_MELS,
                sr: int = SR) -> np.ndarray:
    """HTK-scale triangular filters without normalization, (n_freqs,
    n_mels)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    freqs = np.linspace(0.0, sr / 2.0, n_freqs)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2.0),
                                  n_mels + 2))
    diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def fbank(wav: np.ndarray) -> np.ndarray:
    """(T, 100) log-mel of a mono (1, n) 24 kHz waveform: |STFT| with center
    reflect padding and a periodic Hann window, mel filters, clamp(1e-7),
    log; lhotse's frame count, (n + hop // 2) // hop."""
    x = torch.from_numpy(np.asarray(wav, np.float32).reshape(1, -1))
    spec = torch.stft(x, n_fft=N_FFT, hop_length=HOP, win_length=N_FFT,
                      window=torch.from_numpy(hann(N_FFT)), center=True,
                      pad_mode="reflect", onesided=True, return_complex=True)
    mag = spec.abs().transpose(-1, -2)[0]
    mel = torch.log(torch.clamp(mag @ torch.from_numpy(mel_filters()),
                                min=1e-7)).numpy()
    n = (x.shape[-1] + HOP // 2) // HOP
    if mel.shape[0] > n:
        mel = mel[:n]
    elif mel.shape[0] < n:
        mel = np.concatenate([mel, np.repeat(mel[-1:], n - mel.shape[0], 0)])
    return mel


def prepare_prompt(wav: np.ndarray, feat_scale: float, target_rms: float):
    """(features x feat_scale (T, 100), the prompt's rms, its seconds) of a
    prompt waveform as the program receives it: silences trimmed (trailing
    200 ms kept), rms raised to ``target_rms``, log-mel."""
    wav = remove_silence(wav, SR, only_edge=False, trail_sil=200)
    wav, rms = rms_norm(wav, target_rms)
    return fbank(wav) * feat_scale, rms, wav.shape[-1] / SR


# --- text chunking and batch packing -------------------------------------

def chunk_tokens(tokens: List[str], max_tokens: int) -> List[List[str]]:
    """Sentences cut after punctuation (a following space or mark stays
    with the sentence before), merged greedily into chunks of at most
    ``max_tokens``."""
    sentences, cur = [], []
    for tok in tokens:
        if not cur and sentences and (tok in PUNCTUATION or tok == " "):
            sentences[-1].append(tok)
        else:
            cur.append(tok)
            if tok in PUNCTUATION:
                sentences.append(cur)
                cur = []
    if cur:
        sentences.append(cur)
    chunks, cur = [], []
    for s in sentences:
        if len(cur) + len(s) <= max_tokens:
            cur.extend(s)
        else:
            if cur:
                chunks.append(cur)
            cur = s
    if cur:
        chunks.append(cur)
    return chunks


def pack_batches(chunks: List[List[int]], max_duration: float,
                 prompt_s: float, token_s: float
                 ) -> Tuple[List[List[int]], List[int]]:
    """Chunks sorted by length and packed greedily into batches whose
    generated and prompt seconds stay within ``max_duration``.  Returns
    (batches as lists of chunk indices, sorted order)."""
    order = sorted(range(len(chunks)), key=lambda i: len(chunks[i]))
    batches, batch, size = [], [], 0
    for i in order:
        n = len(chunks[i])
        seconds = size * token_s + len(batch) * prompt_s + n * token_s
        if seconds <= max_duration:
            batch.append(i)
            size += n
        else:
            if batch:
                batches.append(batch)
            batch, size = [i], n
    if batch:
        batches.append(batch)
    return batches, order


def predicted_frames(prompt_frames: np.ndarray, prompt_tokens: np.ndarray,
                     text_tokens: np.ndarray, speed: np.ndarray) -> np.ndarray:
    """Total frames of each row: the prompt's, plus its token rate times the
    text's tokens over the speed, rounded up, in f32."""
    pfl = np.asarray(prompt_frames, np.int32)
    ratio = (pfl.astype(np.float32) / np.asarray(prompt_tokens, np.float32)
             * np.asarray(text_tokens, np.float32)
             / np.asarray(speed, np.float32))
    return pfl + np.ceil(ratio).astype(np.int32)
