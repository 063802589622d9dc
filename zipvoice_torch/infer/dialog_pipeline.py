"""Dialogue inference pipelines, mono and stereo (counterpart of
``zipvoice_tpu/infer/dialog_pipeline.py``).

Mono (ZipVoice-Dialog): the two speakers' prompts are merged into one
("[S1]text1[S2]text2", the wavs silence-trimmed and concatenated), the
dialog text is chunked at [S1] turns to the ~25 s budget, and each chunk is
sampled on its own (B=1), vocoded, and the chunks cross-faded.

Stereo (ZipVoice-Dialog-Stereo): the prompt is two-channel (a stereo wav,
two stereo wavs concatenated, or two mono prompts laid on opposite channels
over silence); its features are (T, 2 x 100), the text is sampled in one
call, and the generated (T, 200) is split into its two channels' mels,
which vocode as two chunks of one batch.

Both run on the base pipeline's ``_sample_batch`` and ``_vocode_chunks``,
on the pipeline's device, with the JAX package's buckets and noise draws.
"""

import time
from typing import List, Union

import numpy as np

from zipvoice_torch.frontend.audio import (
    cross_fade_concat,
    load_wav,
    remove_silence,
    rms_norm,
)
from zipvoice_torch.frontend.feature import VocosFbank
from zipvoice_torch.frontend.text_chunking import chunk_tokens_dialog
from zipvoice_torch.infer.pipeline import InferencePipeline


def _metrics(t_front, start_t, start_voc, wav, sr, chunked_tokens, feats):
    """The JAX package's metrics (``t`` from the first sample to the final
    wav, ``t_vocoder`` from the vocoder on, ``wav_seconds``, ``rtf``) and
    the port's ``t_frontend`` (host seconds of the prompt and text
    preparation), ``chunk_tokens`` and ``frames``."""
    end = time.perf_counter()
    t = end - start_t
    wav_seconds = wav.shape[-1] / sr
    return {
        "t": t,
        "t_vocoder": end - start_voc,
        "wav_seconds": wav_seconds,
        "rtf": t / max(wav_seconds, 1e-9),
        "t_frontend": start_t - t_front,
        "chunk_tokens": [len(c) for c in chunked_tokens],
        "frames": sum(f.shape[0] for f in feats),
    }


class DialogInferencePipeline(InferencePipeline):
    """Mono two-speaker dialogue generation."""

    def _mono_prompt_wav(self, path: str) -> np.ndarray:
        """A prompt wav averaged down to one channel, its silences
        trimmed."""
        wav = load_wav(path, self.sampling_rate)
        if wav.shape[0] == 2:
            wav = wav.mean(axis=0, keepdims=True)
        return remove_silence(wav, self.sampling_rate, only_edge=False,
                              trail_sil=200)

    def merge_prompts(self, prompt_texts: List[str],
                      prompt_wav_paths: List[str]):
        """Two per-speaker prompts -> one: ("[S1]text1[S2]text2", the
        trimmed wavs concatenated (1, n))."""
        wav = np.concatenate(
            [self._mono_prompt_wav(p) for p in prompt_wav_paths], axis=-1
        )
        return f"[S1]{prompt_texts[0]}[S2]{prompt_texts[1]}", wav

    def generate_dialog(self, prompt_text: Union[str, List[str]],
                        prompt_wav_path: Union[str, List[str]], text: str,
                        num_step: int = 16, guidance_scale: float = 1.5,
                        speed: float = 1.0, t_shift: float = 0.5,
                        target_rms: float = 0.1):
        """A dialog text -> (wav (1, n) float32, metrics).  The prompt is a
        merged one (a text with its [S1]/[S2] turns and one wav) or the two
        speakers' (lists of two texts and two wavs).  Every chunk is
        sampled on its own (B=1), as in the JAX package."""
        t_front = time.perf_counter()
        sr = self.sampling_rate
        if isinstance(prompt_wav_path, (list, tuple)):
            prompt_text, prompt_wav = self.merge_prompts(
                list(prompt_text), list(prompt_wav_path)
            )
        else:
            prompt_wav = self._mono_prompt_wav(prompt_wav_path)
        prompt_wav, prompt_rms = rms_norm(prompt_wav, target_rms)
        prompt_features = (self.feature_extractor.extract(prompt_wav, sr)
                           * self.feat_scale)

        tokens_str = self.tokenizer.texts_to_tokens([text])[0]
        prompt_tokens_str = self.tokenizer.texts_to_tokens([prompt_text])[0]
        prompt_duration = prompt_wav.shape[-1] / sr
        token_duration = prompt_duration / max(
            len(prompt_tokens_str) * speed, 1
        )
        max_tokens = max(4, int((25 - prompt_duration) / token_duration))
        chunked_tokens = self.tokenizer.tokens_to_token_ids(
            chunk_tokens_dialog(tokens_str, max_tokens=max_tokens)
        )
        prompt_tokens = self.tokenizer.tokens_to_token_ids(
            [prompt_tokens_str]
        )[0]

        start_t = time.perf_counter()
        feats = []
        for tokens in chunked_tokens:
            f, lens = self._sample_batch(
                [tokens], prompt_tokens, prompt_features,
                num_step=num_step, guidance_scale=guidance_scale,
                speed=speed, t_shift=t_shift,
            )
            feats.append(f[0, : lens[0]])
        start_voc = time.perf_counter()
        wavs = self._vocode_chunks(feats)
        if prompt_rms < target_rms:
            wavs = [w * prompt_rms / target_rms for w in wavs]
        final = cross_fade_concat([w[None] for w in wavs], fade_duration=0.1,
                                  sample_rate=sr)
        final = remove_silence(final, sr, only_edge=True)
        return final, _metrics(t_front, start_t, start_voc, final, sr,
                               chunked_tokens, feats)


class StereoDialogInferencePipeline(DialogInferencePipeline):
    """Two-channel dialogue generation (ZipVoice-Dialog-Stereo)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.feature_extractor = VocosFbank(num_channels=2)

    def _load_stereo_prompt(self, prompt_wav_path: Union[str, List[str]]
                            ) -> np.ndarray:
        """The (2, n) prompt: one stereo wav, two stereo wavs concatenated,
        or two mono wavs on opposite channels, each over the other's
        silence."""
        sr = self.sampling_rate
        if isinstance(prompt_wav_path, str):
            wav = load_wav(prompt_wav_path, sr)
            if wav.shape[0] != 2:
                raise ValueError(
                    "a merged prompt must be stereo for stereo generation"
                )
            return wav
        wavs = [load_wav(p, sr) for p in prompt_wav_path]
        if wavs[0].shape[0] == 2:
            return np.concatenate(wavs, axis=-1)
        n0, n1 = wavs[0].shape[1], wavs[1].shape[1]
        out = np.zeros((2, n0 + n1), np.float32)
        out[0, :n0] = wavs[0][0]
        out[1, n0:] = wavs[1][0]
        return out

    def generate_dialog_stereo(self, prompt_text: Union[str, List[str]],
                               prompt_wav_path: Union[str, List[str]],
                               text: str, num_step: int = 16,
                               guidance_scale: float = 1.5,
                               speed: float = 1.0, t_shift: float = 0.5,
                               target_rms: float = 0.1):
        """A dialog text -> (wav (2, n) float32, metrics), in one sample
        call.  The prompt is merged (a text and a stereo wav) or the two
        speakers' (two texts and two wavs)."""
        t_front = time.perf_counter()
        sr = self.sampling_rate
        if isinstance(prompt_text, (list, tuple)):
            prompt_text = f"[S1]{prompt_text[0]}[S2]{prompt_text[1]}"
        prompt_wav = self._load_stereo_prompt(prompt_wav_path)
        prompt_wav, prompt_rms = rms_norm(prompt_wav, target_rms)
        prompt_features = (self.feature_extractor.extract(prompt_wav, sr)
                           * self.feat_scale)  # (T, 2F)

        tokens = self.tokenizer.texts_to_token_ids([text])[0]
        prompt_tokens = self.tokenizer.texts_to_token_ids([prompt_text])[0]

        start_t = time.perf_counter()
        feats, lens = self._sample_batch(
            [tokens], prompt_tokens, prompt_features,
            num_step=num_step, guidance_scale=guidance_scale, speed=speed,
            t_shift=t_shift,
        )
        feat = feats[0, : lens[0]]  # (T, 2F)
        start_voc = time.perf_counter()
        F = feat.shape[1] // 2
        wav_l, wav_r = self._vocode_chunks([feat[:, :F], feat[:, F:]])
        n = min(len(wav_l), len(wav_r))
        wav = np.stack([wav_l[:n], wav_r[:n]], axis=0)
        if prompt_rms < target_rms:
            wav = wav * prompt_rms / target_rms
        return wav, _metrics(t_front, start_t, start_voc, wav, sr, [tokens],
                             [feat])
