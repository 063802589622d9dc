"""Zero-shot TTS inference pipeline (counterpart of
``zipvoice_tpu/infer/pipeline.py``).

``generate_sentence`` follows the reference's flow (reference
zipvoice/bin/infer_zipvoice.py:437-641): prompt silence-strip -> rms norm
-> fbank x0.1 -> punctuation chunking (~25 s windows) -> duration-bounded
batch packing -> flow-matching sampling -> vocoder -> cross-fade merge ->
edge silence trim.  ``generate_raw`` is the single-call evaluation path and
``generate_stream`` yields cross-faded segments chunk by chunk.

Token and frame lengths snap to the same bucket ladders as the JAX package,
so the two dispatch identical shapes, and noise comes from the pipeline's
seeded ``np.random.RandomState`` exactly as there: the same seed gives the
same noise.  The front end (tokenizer, fbank, silence trim, cross-fade)
runs on the host; sampling and vocoding run on the pipeline's device, and
each micro-batch ends in a copy to the host, so the time stamps around
them hold the device's work.

With ``quantize="int8"`` the model's and the vocoder's matrices live on the
device as int8 with per-channel scales (``serving/quantize.py``), and each
sampling or vocoding call expands them to their dtypes one stack at a
time, so that the expanded bytes alive at once are bounded by the largest
stack, not the whole model.
"""

import logging
import time
from typing import List, Optional

import numpy as np
import torch

from zipvoice_torch.frontend.audio import (
    cross_fade_concat,
    load_wav,
    remove_silence,
    rms_norm,
)
from zipvoice_torch.frontend.batch import bucket_length, pad_tokens
from zipvoice_torch.frontend.feature import VocosFbank
from zipvoice_torch.frontend.text_chunking import (
    add_punctuation,
    batchify_tokens,
    chunk_tokens_punctuation,
)
from zipvoice_torch.models.zipvoice import strip_prompt
from zipvoice_torch.utils import trace
from zipvoice_torch.utils.device import resolve_device

TOKEN_BUCKETS = (32, 64, 96, 128, 192, 256, 384, 512, 768)
FRAME_BUCKETS = (128, 256, 384, 512, 768, 1024, 1280, 1536, 2048, 2560, 3072)
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)


class InferencePipeline:
    def __init__(self, model, vocoder, sampling_rate: int = 24000,
                 feat_scale: float = 0.1, seed: int = 0, device="cuda",
                 tokenizer=None, quantize: Optional[str] = None):
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize={quantize!r}: None or 'int8'")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.vocoder = vocoder.to(self.device).eval()
        self._int8 = None
        if quantize:
            from zipvoice_torch.serving.quantize import Int8Weights

            self._int8 = (Int8Weights(self.model), Int8Weights(self.vocoder))
        self.tokenizer = tokenizer
        self.sampling_rate = sampling_rate
        self.feat_scale = feat_scale
        self.feature_extractor = VocosFbank()
        self.rng = np.random.RandomState(seed)
        self._seen_buckets = set()
        self._engines = None
        self._engine_manifest = None
        # samples served by an exported engine, and those that found none
        # for their bucket or settings
        self.engine_hits = 0
        self.engine_misses = 0

    def attach_engines(self, engine_dir: str) -> None:
        """Serve the shape buckets of an exported engine directory
        (``serving/aot.py``, ``bin/export_model``) from its programs,
        captured as CUDA graphs on the card, instead of running the model's
        code.  Buckets and settings the directory lacks take the model's
        path.  Raises ``ValueError`` if the engines were exported from a
        model or setting other than this pipeline's; a quantized pipeline
        attaches none (the engines take the model's own weights)."""
        if self._int8 is not None:
            logging.warning("engines not attached: the pipeline is int8, "
                            "and the engines run the model's own weights")
            return
        from zipvoice_torch.serving.aot import load_engine_dir

        self._engine_manifest, self._engines = load_engine_dir(
            engine_dir, self.model)
        logging.info(
            f"attached {len(self._engines)} exported engine(s) from "
            f"{engine_dir}: {sorted(self._engines)}"
        )

    def warm_engines(self) -> int:
        """Run every attached engine once at its (B, S, T) bucket, which
        captures its graph, then strip and vocode at B, as ``warm_bucket``
        does.  Returns the number of engines warmed."""
        if not self._engines:
            return 0
        m = self._engine_manifest
        for B, S, T in sorted(self._engines):
            self.warm_bucket(B, S, T, m["num_step"], m["guidance_scale"],
                             m["t_shift"])
        return len(self._engines)

    def _prompt(self, prompt_wav_path: str, target_rms: float,
                trim: bool):
        """(prompt features x feat_scale, prompt rms, prompt seconds) of a
        prompt wav, its silences removed first when ``trim``."""
        sr = self.sampling_rate
        prompt_wav = load_wav(prompt_wav_path, sr)
        if trim:
            prompt_wav = remove_silence(prompt_wav, sr, only_edge=False,
                                        trail_sil=200)
        prompt_wav, prompt_rms = rms_norm(prompt_wav, target_rms)
        features = (self.feature_extractor.extract(prompt_wav, sr)
                    * self.feat_scale)
        return features, prompt_rms, prompt_wav.shape[-1] / sr

    def generate_sentence(self, prompt_text: str, prompt_wav_path: str,
                          text: str, num_step: int = 16,
                          guidance_scale: float = 1.0, speed: float = 1.0,
                          t_shift: float = 0.5, target_rms: float = 0.1,
                          max_duration: float = 100.0,
                          remove_long_sil: bool = False):
        """Returns (wav (C, T) float32, metrics dict).  Besides the JAX
        package's metrics, ``t_frontend`` is the host seconds of the prompt
        and text preparation, ``chunk_tokens`` the token count of each
        chunk, and ``frames`` the generated frames over all chunks.  While
        tracing is on (``utils/trace.py``), ``trace`` is the call's spans
        and counters."""
        t_front = time.perf_counter()
        traced = trace.on
        if traced:
            trace.begin(t_front)
            front = trace.span("zv.frontend", t_front)
        sr = self.sampling_rate
        prompt_features, prompt_rms, prompt_duration = self._prompt(
            prompt_wav_path, target_rms, trim=True
        )
        if prompt_duration > 10:
            logging.warning(
                f"prompt is long ({prompt_duration:.1f}s); 1-3 s recommended"
            )

        text = add_punctuation(text)
        prompt_text = add_punctuation(prompt_text)
        tokens_str = self.tokenizer.texts_to_tokens([text])[0]
        prompt_tokens_str = self.tokenizer.texts_to_tokens([prompt_text])[0]

        token_duration = prompt_duration / (len(prompt_tokens_str) * speed)
        max_tokens = max(4, int((25 - prompt_duration) / token_duration))
        chunked_tokens_str = chunk_tokens_punctuation(
            tokens_str, max_tokens=max_tokens
        )
        chunked_tokens = self.tokenizer.tokens_to_token_ids(chunked_tokens_str)
        prompt_tokens = self.tokenizer.tokens_to_token_ids(
            [prompt_tokens_str]
        )[0]

        tokens_batches, chunked_index = batchify_tokens(
            chunked_tokens, max_duration, prompt_duration, token_duration
        )

        start_t = time.perf_counter()
        if traced:
            front.end(start_t)
        chunked_feats: List[np.ndarray] = []
        for batch_tokens in tokens_batches:
            feats, feats_lens = self._sample_batch(
                batch_tokens, prompt_tokens, prompt_features,
                num_step=num_step, guidance_scale=guidance_scale,
                speed=speed, t_shift=t_shift,
            )
            for i in range(len(batch_tokens)):
                chunked_feats.append(feats[i, : feats_lens[i]])

        start_vocoder_t = time.perf_counter()
        chunked_wavs = self._vocode_chunks(chunked_feats)
        end_t = time.perf_counter()
        t = end_t - start_t
        if traced:
            merge = trace.span("zv.merge", end_t)

        if prompt_rms < target_rms:
            chunked_wavs = [w * prompt_rms / target_rms for w in chunked_wavs]

        order = sorted(range(len(chunked_wavs)),
                       key=lambda i: chunked_index[i])
        seq_wavs = [chunked_wavs[i][None] for i in order]
        final_wav = cross_fade_concat(seq_wavs, fade_duration=0.1,
                                      sample_rate=sr)
        final_wav = remove_silence(
            final_wav, sr, only_edge=(not remove_long_sil), trail_sil=0
        )
        if traced:
            call_trace = trace.finish(merge.end())

        t_no_vocoder = start_vocoder_t - start_t
        t_vocoder = t - t_no_vocoder
        wav_seconds = final_wav.shape[-1] / sr
        metrics = {
            "t": t,
            "t_no_vocoder": t_no_vocoder,
            "t_vocoder": t_vocoder,
            "wav_seconds": wav_seconds,
            "rtf": t / max(wav_seconds, 1e-9),
            "rtf_no_vocoder": t_no_vocoder / max(wav_seconds, 1e-9),
            "rtf_vocoder": t_vocoder / max(wav_seconds, 1e-9),
            "t_frontend": start_t - t_front,
            "chunk_tokens": [len(c) for c in chunked_tokens],
            "frames": sum(f.shape[0] for f in chunked_feats),
        }
        if traced:
            metrics["trace"] = call_trace
        return final_wav, metrics

    def generate_stream(self, prompt_tokens: List[int],
                        prompt_features: np.ndarray, text: str,
                        num_step: int = 16, guidance_scale: float = 1.0,
                        speed: float = 1.0, t_shift: float = 0.5,
                        prompt_rms: float = 0.1, target_rms: float = 0.1,
                        fade_duration: float = 0.1):
        """Stream wav segments as text chunks are synthesized.

        Chunks run one at a time (B=1), so the first audio arrives after a
        single sample + vocode round, and the linear cross-fade of
        ``cross_fade_concat`` is applied incrementally: the yielded
        segments concatenate to the offline result.  ``prompt_tokens`` and
        ``prompt_features`` are a prepared prompt (features already
        feat-scaled)."""
        sr = self.sampling_rate
        prompt_duration = prompt_features.shape[0] * 256 / sr
        text = add_punctuation(text)
        tokens_str = self.tokenizer.texts_to_tokens([text])[0]
        token_duration = prompt_duration / (len(prompt_tokens) * speed)
        max_tokens = max(4, int((25 - prompt_duration) / token_duration))
        chunked_tokens = self.tokenizer.tokens_to_token_ids(
            chunk_tokens_punctuation(tokens_str, max_tokens=max_tokens)
        )

        fade = int(fade_duration * sr)
        carry: Optional[np.ndarray] = None
        gain = prompt_rms / target_rms if prompt_rms < target_rms else 1.0
        for tok in chunked_tokens:
            feats, lens = self._sample_batch(
                [tok], prompt_tokens, prompt_features,
                num_step=num_step, guidance_scale=guidance_scale,
                speed=speed, t_shift=t_shift,
            )
            wav = self._vocode_chunks([feats[0, : lens[0]]])[0][None] * gain
            if carry is None:
                merged = wav
            else:
                k = min(fade, carry.shape[-1], wav.shape[-1])
                if k > 0:
                    ramp = np.linspace(1.0, 0.0, k, dtype=wav.dtype)[None]
                    merged = np.concatenate(
                        [carry[..., :-k],
                         carry[..., -k:] * ramp + wav[..., :k] * (1 - ramp),
                         wav[..., k:]], axis=-1,
                    )
                else:
                    merged = np.concatenate([carry, wav], axis=-1)
            if merged.shape[-1] > fade:
                yield merged[..., :-fade]
                carry = merged[..., -fade:]
            else:
                carry = merged
        if carry is not None and carry.shape[-1]:
            yield carry

    def generate_raw(self, prompt_text: str, prompt_wav_path: str,
                     text: str, num_step: int = 16,
                     guidance_scale: float = 1.0, speed: float = 1.0,
                     t_shift: float = 0.5, target_rms: float = 0.1):
        """Raw-evaluation path (reference infer_zipvoice.py:315-434): no
        silence removal, no chunking, no cross-fade; a single sample call,
        for objective benchmark comparability."""
        prompt_features, prompt_rms, _ = self._prompt(
            prompt_wav_path, target_rms, trim=False
        )
        tokens = self.tokenizer.texts_to_token_ids([text])[0]
        prompt_tokens = self.tokenizer.texts_to_token_ids([prompt_text])[0]

        start_t = time.perf_counter()
        feats, lens = self._sample_batch(
            [tokens], prompt_tokens, prompt_features,
            num_step=num_step, guidance_scale=guidance_scale,
            speed=speed, t_shift=t_shift,
        )
        wav = self._vocode_chunks([feats[0, : lens[0]]])[0][None]
        if prompt_rms < target_rms:
            wav = wav * prompt_rms / target_rms
        t = time.perf_counter() - start_t
        wav_seconds = wav.shape[-1] / self.sampling_rate
        return wav, {
            "t": t,
            "wav_seconds": wav_seconds,
            "rtf": t / max(wav_seconds, 1e-9),
        }

    def warm_bucket(self, B: int, S: int, T: int, num_step: int,
                    guidance_scale: float, t_shift: float = 0.5) -> None:
        """Run the sample and vocoder path once at one (batch, token,
        frame) bucket, snapped to the ladders, so that later traffic there
        finds the kernels built and the allocator warm.  A server warms
        through its engine (``TTSEngine.warm``) instead, so that the
        threads and streams that serve the traffic are the ones warmed."""
        x1_wo, wo_lens, B = self._warm_sample_device(
            B, S, T, num_step, guidance_scale, t_shift)
        n = max(int(wo_lens[0]), 1)
        # B chunks vocode as one (B, T) batch, the shape real traffic takes
        self._vocode_chunks([x1_wo[0, :n].float().cpu().numpy()] * B)

    def _warm_sample_device(self, B: int, S: int, T: int, num_step: int,
                            guidance_scale: float, t_shift: float = 0.5):
        """Queue ``warm_bucket``'s sample at the bucket that (B, S, T)
        snaps to: a prompt of min(64, T) zero frames and S ones for tokens.
        Returns the device tensors (generated features, their lengths, B)
        as ``_sample_batch_device`` does, every row real."""
        B_b, S_b, T_b = (
            bucket_length(B, BATCH_BUCKETS),
            bucket_length(S, TOKEN_BUCKETS),
            bucket_length(T, FRAME_BUCKETS),
        )
        if (B_b, S_b, T_b) != (B, S, T):
            logging.warning(
                f"warm_bucket({B},{S},{T}) is off the bucket ladder; "
                f"snapping to B={B_b} S={S_b} T={T_b}"
            )
            B, S, T = B_b, S_b, T_b
        F = self.model.feat_dim

        def full(n):
            return np.full((B,), n, np.int64)

        x1_wo, wo_lens = self._sample_device(
            dict(tokens=np.ones((B, S), np.int64), tokens_lens=full(S),
                 prompt_tokens_lens=full(max(S // 4, 1)),
                 prompt_features=np.zeros((B, T, F), np.float32),
                 prompt_features_lens=full(min(64, T)), features_lens=full(T),
                 noise=np.zeros((B, T, F), np.float32)),
            num_step, guidance_scale, t_shift)
        self._seen_buckets.add((B, S, T))
        logging.info(f"warmed bucket B={B} S={S} T={T}")
        return x1_wo, wo_lens, B

    def _sample_batch(self, batch_tokens, prompt_tokens, prompt_features,
                      num_step, guidance_scale, speed, t_shift):
        """Sample one micro-batch; returns host (features (B, T, F) with
        the feature scale undone, generated lengths (B,))."""
        x1_wo, wo_lens, B_real = self._sample_batch_device(
            batch_tokens, prompt_tokens, prompt_features,
            num_step=num_step, guidance_scale=guidance_scale,
            speed=speed, t_shift=t_shift,
        )
        traced = trace.on
        if traced:
            copy_out = trace.span("zv.sample.copy_out")
        feats = x1_wo[:B_real].float().cpu().numpy() / self.feat_scale
        lens = wo_lens[:B_real].cpu().numpy()
        if traced:
            trace.drained(copy_out.end())
        return feats, lens

    def _sample_batch_device(self, batch_tokens, prompt_tokens,
                             prompt_features, num_step, guidance_scale,
                             speed, t_shift):
        """Queue one sample micro-batch on the device and return its device
        tensors (generated features, their lengths, the real batch size)
        without waiting for them: nothing here syncs with the host.

        ``prompt_tokens`` may be one token list shared by the batch or one
        list per row; ``prompt_features`` one (T, F) array or one per row;
        ``speed`` a scalar or one per row.  The batch pads to its bucket by
        repeating row 0."""
        traced = trace.on
        if traced:
            prepare = trace.span("zv.sample.prepare")
        B_real = len(batch_tokens)
        B = bucket_length(B_real, BATCH_BUCKETS)
        if prompt_tokens and isinstance(prompt_tokens[0], (list, tuple)):
            prompt_tokens_rows = [list(t) for t in prompt_tokens]
        else:
            prompt_tokens_rows = [list(prompt_tokens)] * B_real
        if isinstance(prompt_features, (list, tuple)):
            prompt_feat_rows = list(prompt_features)
        else:
            prompt_feat_rows = [prompt_features] * B_real
        if not len(prompt_tokens_rows) == len(prompt_feat_rows) == B_real:
            raise ValueError(
                f"{len(prompt_tokens_rows)} prompt token rows and "
                f"{len(prompt_feat_rows)} prompt feature rows for "
                f"{B_real} texts"
            )
        speed_rows = (
            np.asarray(speed, np.float32)
            if np.ndim(speed) else np.full((B_real,), speed, np.float32)
        )
        cat_tokens = [p + t for p, t in zip(prompt_tokens_rows, batch_tokens)]
        cat_tokens += [cat_tokens[0]] * (B - B_real)
        S = bucket_length(max(len(t) for t in cat_tokens) + 1, TOKEN_BUCKETS)
        tok, tok_lens = pad_tokens(cat_tokens, pad_id=self.model.pad_id,
                                   pad_to=S)

        def _pad_row(arr, n):
            if n == len(arr):
                return arr
            return np.concatenate(
                [arr, np.full(n - len(arr), arr[0], arr.dtype)]
            )

        ptl = _pad_row(
            np.array([len(p) for p in prompt_tokens_rows], np.int32), B
        )
        pfl = _pad_row(
            np.array([f.shape[0] for f in prompt_feat_rows], np.int32), B
        )
        text_lens = _pad_row(
            np.array([len(t) for t in batch_tokens], np.int32), B
        )
        speed_b = _pad_row(speed_rows, B)
        # duration prediction in f32, as the JAX pipeline does it
        fl = pfl + np.ceil(
            pfl.astype(np.float32) / ptl.astype(np.float32)
            * text_lens.astype(np.float32) / speed_b
        ).astype(np.int32)
        if int(fl.max()) > FRAME_BUCKETS[-1]:
            logging.warning(
                f"predicted {int(fl.max())} frames exceeds the largest "
                f"bucket {FRAME_BUCKETS[-1]}; truncating"
            )
            fl = np.minimum(fl, FRAME_BUCKETS[-1])
        T = bucket_length(int(fl.max()), FRAME_BUCKETS)
        F = prompt_feat_rows[0].shape[1]
        pfl = np.minimum(pfl, T)
        pf = np.zeros((B, T, F), np.float32)
        for i in range(B):
            row = prompt_feat_rows[i if i < B_real else 0]
            n = min(row.shape[0], T)
            pf[i, :n] = row[:n]
        noise = self.rng.randn(B, T, F).astype(np.float32)

        if (B, S, T) not in self._seen_buckets:
            self._seen_buckets.add((B, S, T))
            logging.info(f"sample bucket B={B} S={S} T={T}")
        if traced:
            trace.count("sample.row_frames", B * T)
            trace.count("sample.real_frames", int(fl[:B_real].sum()))
            prepare.end()

        x1_wo, wo_lens = self._sample_device(
            dict(tokens=tok, tokens_lens=tok_lens, prompt_tokens_lens=ptl,
                 prompt_features=pf, prompt_features_lens=pfl,
                 features_lens=fl, noise=noise),
            num_step, guidance_scale, t_shift)
        return x1_wo, wo_lens, B_real

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the pipeline's device: on the card through
        pinned memory, asynchronously, so that no upload waits for the
        work already queued on the stream and a server can queue this
        batch behind the one the card is running."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _engine_for(self, B: int, S: int, T: int, num_step: int,
                    guidance_scale: float, t_shift: float):
        """The attached engine that serves this bucket and these settings,
        or None (an ``engine miss`` line when engines are attached)."""
        if self._engines is None:
            return None
        m = self._engine_manifest
        settings = (num_step, guidance_scale, t_shift)
        baked = (m["num_step"], m["guidance_scale"], m["t_shift"])
        eng = self._engines.get((B, S, T)) if settings == baked else None
        if eng is None:
            self.engine_misses += 1
            logging.info(
                f"engine miss: bucket B={B} S={S} T={T} with (num_step, "
                f"guidance_scale, t_shift) {settings}; the engines have "
                f"{sorted(self._engines)} at {baked}"
            )
        else:
            self.engine_hits += 1
        return eng

    def _sample_device(self, host, num_step: int, guidance_scale: float,
                       t_shift: float):
        """Queue the sample of ``sample``'s inputs, given as host arrays by
        name, and return its device tensors (generated features with the
        prompt stripped, their lengths): through the attached engine of
        their bucket when there is one, else through the model.
        ``strip_prompt`` makes new tensors on this stream, so nothing
        returned is the engine's graph buffer, which its next replay
        overwrites."""
        names = ("tokens", "tokens_lens", "prompt_tokens_lens",
                 "prompt_features", "prompt_features_lens", "features_lens",
                 "noise")
        traced = trace.on
        if traced:
            enqueue = trace.span("zv.sample.enqueue", device=self.device)
            trace.queued(enqueue.t0)
        inputs = {}
        for n in names:
            t = self._upload(host[n])
            inputs[n] = t if t.is_floating_point() else t.long()
        B, S = host["tokens"].shape
        T = host["noise"].shape[1]
        with torch.inference_mode():
            eng = self._engine_for(B, S, T, num_step, guidance_scale,
                                   t_shift)
            if eng is not None:
                x1, padding_mask = eng(*inputs.values())
            else:
                x1, padding_mask = self._run_model(
                    "sample", **inputs, num_step=num_step,
                    guidance_scale=guidance_scale, t_shift=t_shift)
            out = strip_prompt(x1, padding_mask,
                               inputs["prompt_features_lens"])
        if traced:
            enqueue.end()
        return out

    def _run_model(self, method: str, **inputs):
        """``self.model.<method>(**inputs)``, on the int8 weights expanded
        a stack at a time when the pipeline is quantized."""
        if self._int8 is None:
            return getattr(self.model, method)(**inputs)
        return self._int8[0](method, **inputs)

    def _run_vocoder(self, mel: torch.Tensor) -> torch.Tensor:
        if self._int8 is None:
            return self.vocoder(mel)
        return self._int8[1]("forward", mel)

    def weight_bytes(self) -> int:
        """Bytes of the model's and the vocoder's weights on the device
        (int8 tensors and their scales when quantized)."""
        if self._int8 is not None:
            return sum(w.resident_bytes() for w in self._int8)
        return sum(p.numel() * p.element_size()
                   for m in (self.model, self.vocoder)
                   for p in m.parameters())

    def _vocode_chunks(self, feats: List[np.ndarray]) -> List[np.ndarray]:
        """Vocode variable-length mel chunks, batched by frame bucket."""
        out: List[Optional[np.ndarray]] = [None] * len(feats)
        groups = {}
        for i, f in enumerate(feats):
            groups.setdefault(
                bucket_length(f.shape[0], FRAME_BUCKETS), []
            ).append(i)
        hop = self.vocoder.hop_length
        traced = trace.on
        for T, idxs in groups.items():
            if traced:
                group = trace.span("zv.vocode")
            B = bucket_length(len(idxs), BATCH_BUCKETS)
            mel = np.zeros((B, T, feats[0].shape[1]), np.float32)
            for j, i in enumerate(idxs):
                mel[j, : feats[i].shape[0]] = feats[i]
            if traced:
                trace.queued()
            with torch.inference_mode():
                wav = torch.clamp(
                    self._run_vocoder(torch.from_numpy(mel).to(self.device)),
                    -1.0, 1.0,
                ).cpu().numpy()
            if traced:
                trace.drained(group.end())
            for j, i in enumerate(idxs):
                out[i] = wav[j, : feats[i].shape[0] * hop]
        return out
