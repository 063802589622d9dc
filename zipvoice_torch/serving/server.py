"""TTS serving on the card: an HTTP server with micro-batching and a speaker
cache (counterpart of ``zipvoice_tpu/serving/server.py``).

- Requests queue up; a sampler thread forms micro-batches, grouped by the
  frame bucket their predicted lengths fall in, and queues one sample per
  group on the card, rows of different speakers together;
- a finisher thread takes each batch's features as they reach the host,
  vocodes them on a stream of its own and replies, so that batch N's
  vocoding may overlap batch N+1's sampling (whether it does depends on
  the sampler, which is host-bound and queues every kernel itself);
- a speaker cache keeps each speaker's prompt features and tokens, so a
  request names a speaker and skips the fbank and the G2P;
- plain HTTP/JSON (base64 wav in and out) through ``http.server``.

  python -m zipvoice_torch.serving.server --model-dir DIR --port 8000 \\
      --warmup-buckets 8:192:1280

POST /tts        {"text": ..., "prompt_text": ..., "prompt_wav_b64": ...}
POST /tts        {"text": ..., "speaker": "cached_name"}
POST /speaker    {"name": ..., "prompt_text": ..., "prompt_wav_b64": ...}
GET  /health

OpenAI-compatible:

POST /v1/audio/speech  {"model": ..., "input": text, "voice": speaker,
                        "response_format": "wav"|"pcm", "speed": 1.0}
                       -> raw audio bytes (voice = a cached speaker name)
GET  /v1/models
"""

import argparse
import base64
import binascii
import contextlib
import io
import json
import logging
import queue
import threading
import time
import wave
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from zipvoice_torch.frontend.audio import remove_silence, resample, rms_norm
from zipvoice_torch.frontend.batch import bucket_length
from zipvoice_torch.infer.pipeline import BATCH_BUCKETS, FRAME_BUCKETS


class SpeakerCache:
    def __init__(self, pipeline):
        self.pipeline = pipeline
        self._cache: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def add(self, name: str, prompt_text: str, wav: np.ndarray, sr: int):
        """Prepare a prompt once (resample to the pipeline's rate, trim
        silences, rms-normalize, fbank x feat_scale, tokens) and keep it
        under ``name``."""
        pipe = self.pipeline
        if sr != pipe.sampling_rate:
            wav = resample(wav, sr, pipe.sampling_rate)
        wav = remove_silence(wav, pipe.sampling_rate, trail_sil=200)
        wav, prompt_rms = rms_norm(wav, 0.1)
        feats = pipe.feature_extractor.extract(
            wav, pipe.sampling_rate
        ) * pipe.feat_scale
        tokens = pipe.tokenizer.texts_to_token_ids([prompt_text])[0]
        entry = {
            "features": feats,
            "tokens": tokens,
            "prompt_rms": prompt_rms,
            "duration": wav.shape[-1] / pipe.sampling_rate,
        }
        with self._lock:
            self._cache[name] = entry
        return entry

    def get(self, name: str) -> Optional[dict]:
        with self._lock:
            return self._cache.get(name)


def _on_device(device: torch.device):
    """The calling thread's current CUDA device set to ``device`` (a no-op
    on the CPU): the current device is per thread."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _new_stream(device: torch.device):
    return torch.cuda.Stream(device) if device.type == "cuda" else None


class TTSEngine:
    """Micro-batching engine around an ``InferencePipeline``, in two
    stages.

    - The SAMPLER thread forms micro-batches and queues each one's sample
      on the card's current stream, then, on a copy stream, the copy of its
      features and lengths into pinned host memory, and hands the batch on
      with the copy's event.  ``_sample_batch_device`` never syncs with the
      host, so the sampler goes straight back to the queue and may queue
      the next batch behind this one.
    - The FINISHER thread waits for that event only, vocodes on a stream
      of its own, trims and replies.

    So batch N's copy, vocoding and replies may overlap batch N+1's
    sampling; they do only when the sampler has queued batch N+1 before
    batch N's features reach the host.
    The hand-off queue holds two batches: the sampler runs at most that
    far ahead of the finisher.  Each thread enters its own inference mode
    and current device, which are per thread; the pipeline's noise
    generator and bucket set are the sampler's alone.  ``close()`` stops
    both threads.  ``warm`` runs a bucket through both threads before
    traffic comes.
    """

    def __init__(self, pipeline, max_batch: int = 8,
                 batch_window_ms: float = 10.0, num_step: int = 16,
                 guidance_scale: float = 1.0):
        self.pipeline = pipeline
        self.cache = SpeakerCache(pipeline)
        self.max_batch = max_batch
        self.batch_window = batch_window_ms / 1000.0
        self.num_step = num_step
        self.guidance_scale = guidance_scale
        self.q: "queue.Queue" = queue.Queue()
        self._inflight: "queue.Queue" = queue.Queue(maxsize=2)
        self._sampler = threading.Thread(target=self._run_sampler,
                                         daemon=True)
        self._finisher = threading.Thread(target=self._run_finisher,
                                          daemon=True)
        self._sampler.start()
        self._finisher.start()

    def submit(self, speaker_entry: dict, text: str,
               speed: float = 1.0) -> "queue.Queue":
        """Queue one request; its reply, ("ok", wav, timing) or ("error",
        message, {}), arrives on the returned queue."""
        done: "queue.Queue" = queue.Queue(maxsize=1)
        timing = {"submit": time.perf_counter()}
        tokens = self.pipeline.tokenizer.texts_to_token_ids([text])[0]
        timing["tokenized"] = time.perf_counter()
        self.q.put((speaker_entry, tokens, done, speed, timing))
        return done

    def warm(self, B: int, S: int, T: int, timeout: float = 600.0) -> None:
        """Run ``InferencePipeline.warm_bucket``'s sample and vocoding at
        one bucket through the engine itself: the sample on the sampler's
        thread and stream, the vocoding on the finisher's.  The library
        handles, cuBLAS workspaces and allocator pools are per thread or
        per stream, so warming on another thread would leave them cold for
        the first request.  Returns once the batch is vocoded."""
        done: "queue.Queue" = queue.Queue()
        self.q.put(_Warm(B, S, T, done))
        for _ in range(bucket_length(B, BATCH_BUCKETS)):
            status, result, _ = done.get(timeout=timeout)
            if status != "ok":
                raise RuntimeError(f"warming B={B} S={S} T={T}: {result}")

    def close(self, timeout: float = 60.0) -> None:
        """Stop the threads once the batches already queued are done."""
        self.q.put(None)
        self._sampler.join(timeout)
        self._finisher.join(timeout)

    def _group(self, batch):
        """The batch's requests grouped by the frame bucket of their
        predicted lengths.  Only the bucket: the pipeline takes per-row
        prompts and speeds, so requests of different speakers share a
        micro-batch, while rows of one length pad no row to a longer
        bucket and make no new shape."""
        by_bucket: Dict[int, List] = {}
        for item in batch:
            entry, tokens, _, speed, _ = item
            pfl = entry["features"].shape[0]
            ptl = max(len(entry["tokens"]), 1)
            fl = pfl + int(np.ceil(pfl / ptl * len(tokens) / max(speed, 1e-6)))
            tb = bucket_length(min(fl, FRAME_BUCKETS[-1]), FRAME_BUCKETS)
            by_bucket.setdefault(tb, []).append(item)
        return list(by_bucket.values())

    def _run_sampler(self):
        pipe = self.pipeline
        with torch.inference_mode(), _on_device(pipe.device):
            copy_stream = _new_stream(pipe.device)
            while True:
                first = self.q.get()
                if first is None:
                    self._inflight.put(None)
                    return
                if isinstance(first, _Warm):
                    self._warm_batch(first, copy_stream)
                    continue
                batch = [first]
                deadline = time.perf_counter() + self.batch_window
                while len(batch) < self.max_batch:
                    timeout = deadline - time.perf_counter()
                    if timeout <= 0:
                        break
                    try:
                        item = self.q.get(timeout=timeout)
                    except queue.Empty:
                        break
                    if item is None or isinstance(item, _Warm):
                        # close() or a warm-up: finish this batch first
                        self.q.put(item)
                        break
                    batch.append(item)
                try:
                    groups = self._group(batch)
                except Exception as e:  # noqa: BLE001
                    # a grouping failure must not kill the sampler thread:
                    # every queued request would hang with no reply
                    logging.exception("batch grouping failed")
                    for _, _, done, _, _ in batch:
                        done.put(("error", str(e), {}))
                    continue
                for items in groups:
                    t_dispatch = time.perf_counter()
                    for *_, tm in items:
                        tm["dispatch"] = t_dispatch
                    try:
                        dev = pipe._sample_batch_device(
                            [tokens for _, tokens, _, _, _ in items],
                            [e["tokens"] for e, _, _, _, _ in items],
                            [e["features"] for e, _, _, _, _ in items],
                            num_step=self.num_step,
                            guidance_scale=self.guidance_scale,
                            speed=[s for _, _, _, s, _ in items],
                            t_shift=0.5,
                        )
                        host = _to_host(dev, copy_stream)
                    except Exception as e:  # noqa: BLE001
                        logging.exception("sample dispatch failed")
                        for _, _, done, _, _ in items:
                            done.put(("error", str(e), {}))
                        continue
                    t_dispatched = time.perf_counter()
                    for *_, tm in items:
                        tm["dispatched"] = t_dispatched
                    # blocks while two batches are in flight
                    self._inflight.put((items, host))

    def _warm_batch(self, warm: "_Warm", copy_stream) -> None:
        """The sampler's part of ``warm``: one warm-up sample, handed to
        the finisher as a batch of rows that all reply to ``warm.done``."""
        try:
            dev = self.pipeline._warm_sample_device(
                warm.B, warm.S, warm.T, num_step=self.num_step,
                guidance_scale=self.guidance_scale, t_shift=0.5)
            host = _to_host(dev, copy_stream)
        except Exception as e:  # noqa: BLE001
            logging.exception("warm-up dispatch failed")
            for _ in range(bucket_length(warm.B, BATCH_BUCKETS)):
                warm.done.put(("error", str(e), {}))
            return
        items = [({"prompt_rms": 0.1}, None, warm.done, 1.0, {})
                 for _ in range(dev[2])]
        self._inflight.put((items, host))

    def _run_finisher(self):
        pipe = self.pipeline
        with torch.inference_mode(), _on_device(pipe.device):
            stream = _new_stream(pipe.device)
            while True:
                got = self._inflight.get()
                if got is None:
                    return
                items, (x1_wo, wo_lens, ready) = got
                try:
                    if ready is not None:
                        ready.synchronize()
                    feats = x1_wo.numpy() / pipe.feat_scale
                    lens = wo_lens.numpy()
                    t_dev = time.perf_counter()
                    with torch.cuda.stream(stream):
                        wavs = pipe._vocode_chunks(
                            [feats[i, : lens[i]] for i in range(len(items))])
                    t_voc = time.perf_counter()
                    for (entry, _, done, _, tm), wav in zip(items, wavs):
                        if entry["prompt_rms"] < 0.1:
                            wav = wav * entry["prompt_rms"] / 0.1
                        tm["device_done"] = t_dev
                        tm["vocoded"] = t_voc
                        done.put(("ok", wav, tm))
                except Exception as e:  # noqa: BLE001
                    logging.exception("finish failed")
                    for _, _, done, _, _ in items:
                        done.put(("error", str(e), {}))


class _Warm:
    """A warm-up request on the engine's queue: one (B, S, T) bucket and
    the queue that its rows reply to."""

    def __init__(self, B: int, S: int, T: int, done: "queue.Queue"):
        self.B, self.S, self.T, self.done = B, S, T, done


def _to_host(dev, copy_stream):
    """Queue the copy of a sampled batch's real rows (features, lengths)
    into pinned host memory: on ``copy_stream`` behind the sample, with an
    event recorded after it, which is returned beside the host tensors.
    On the CPU the tensors are already on the host and there is no
    event."""
    x1_wo, wo_lens, B_real = dev
    x, n = x1_wo[:B_real], wo_lens[:B_real]
    if copy_stream is None:
        return x, n, None
    copy_stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(copy_stream):
        host_x = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host_n = torch.empty(n.shape, dtype=n.dtype, pin_memory=True)
        host_x.copy_(x, non_blocking=True)
        host_n.copy_(n, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(copy_stream)
    # allocated on the sampler's stream and read on the copy stream: the
    # allocator must not hand their memory out again before the copy ends
    x1_wo.record_stream(copy_stream)
    wo_lens.record_stream(copy_stream)
    return host_x, host_n, ready


def _wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    x = (np.clip(wav, -1, 1) * 32767).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(x.tobytes())
    return buf.getvalue()


def _decode_wav_b64(b64: str):
    raw = base64.b64decode(b64)
    with wave.open(io.BytesIO(raw), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        ch = f.getnchannels()
        data = np.frombuffer(f.readframes(n), np.int16)
    wav = (data.astype(np.float32) / 32768.0).reshape(-1, ch).T
    return wav, sr


# what a request with missing or malformed fields raises while it is read
_BAD_REQUEST = (KeyError, TypeError, ValueError, EOFError, wave.Error,
                binascii.Error)


def make_handler(engine: TTSEngine, model_name: str = "zipvoice"):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            logging.debug(fmt % args)

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _bytes(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _openai_error(self, code: int, message: str,
                          err_type: str = "invalid_request_error"):
            self._json(code, {"error": {"message": message,
                                        "type": err_type}})

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"status": "ok"})
            elif self.path == "/v1/models":
                self._json(200, {
                    "object": "list",
                    "data": [{"id": model_name, "object": "model",
                              "owned_by": "zipvoice_torch"}],
                })
            else:
                self._json(404, {"error": "not found"})

        def _openai_speech(self, req: dict):
            """OpenAI /v1/audio/speech: voice = a cached speaker name."""
            text = req.get("input")
            voice = req.get("voice")
            if not text or not voice:
                self._openai_error(400, "'input' and 'voice' are required")
                return
            entry = engine.cache.get(voice)
            if entry is None:
                self._openai_error(
                    404,
                    f"unknown voice {voice!r}; register it first via "
                    "POST /speaker",
                )
                return
            speed = float(req.get("speed", 1.0))
            fmt = req.get("response_format", "wav")
            if fmt not in ("wav", "pcm"):
                self._openai_error(
                    400, f"response_format {fmt!r} unsupported (wav|pcm)"
                )
                return
            status, result, _ = engine.submit(entry, text, speed=speed).get()
            if status != "ok":
                self._openai_error(500, result, "server_error")
                return
            sr = engine.pipeline.sampling_rate
            if fmt == "pcm":
                pcm = (np.clip(result, -1, 1) * 32767).astype("<i2")
                self._bytes(200, pcm.tobytes(), "audio/pcm")
            else:
                self._bytes(200, _wav_bytes(result, sr), "audio/wav")

        def _tts(self, req: dict):
            t0 = time.perf_counter()
            if "speaker" in req:
                entry = engine.cache.get(req["speaker"])
                if entry is None:
                    self._json(404, {"error": "unknown speaker"})
                    return
            else:
                wav, sr = _decode_wav_b64(req["prompt_wav_b64"])
                entry = engine.cache.add(
                    f"_anon_{time.time()}", req["prompt_text"], wav, sr
                )
            status, result, tm = engine.submit(entry, req["text"]).get()
            if status != "ok":
                self._json(500, {"error": result})
                return
            sr = engine.pipeline.sampling_rate
            sub = tm["submit"]
            self._json(200, {
                "wav_b64": base64.b64encode(_wav_bytes(result, sr)).decode(),
                "sample_rate": sr,
                "latency_s": time.perf_counter() - t0,
                "audio_s": len(result) / sr,
                "timing": {
                    "tokenize_ms": (tm["tokenized"] - sub) * 1e3,
                    "queue_ms": (tm["dispatch"] - tm["tokenized"]) * 1e3,
                    "sample_ms": (tm["device_done"] - tm["dispatch"]) * 1e3,
                    "vocode_ms": (tm["vocoded"] - tm["device_done"]) * 1e3,
                },
            })

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(length))
            except json.JSONDecodeError:
                self._json(400, {"error": "bad json"})
                return
            try:
                if self.path == "/v1/audio/speech":
                    self._openai_speech(req)
                elif self.path == "/speaker":
                    wav, sr = _decode_wav_b64(req["prompt_wav_b64"])
                    engine.cache.add(req["name"], req["prompt_text"], wav,
                                     sr)
                    self._json(200, {"status": "ok"})
                elif self.path == "/tts":
                    self._tts(req)
                else:
                    self._json(404, {"error": "not found"})
            except _BAD_REQUEST as e:
                self._json(400, {"error": f"bad request: {e!r}"})

    return Handler


def warmup_batches(max_batch: int) -> List[int]:
    """Every batch bucket up to ``max_batch``, which is rounded UP to its
    bucket: micro-batching forms intermediate sizes (2, 4, ...) as soon as
    two requests land in one window, and traffic at ``--max-batch 6`` runs
    at B=8, so a B=6 program would leave the real bucket cold."""
    return sorted({b for b in BATCH_BUCKETS if b <= max_batch}
                  | {bucket_length(max_batch, BATCH_BUCKETS)})


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-dir", type=str, required=True)
    p.add_argument("--model-name", type=str, default="zipvoice_distill")
    p.add_argument("--vocoder-path", type=str, default=None)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--num-step", type=int, default=4)
    p.add_argument("--guidance-scale", type=float, default=3.0)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--warmup", action="store_true",
                   help="run every batch bucket up to --max-batch at "
                        "three (token, frame) buckets before accepting "
                        "traffic")
    p.add_argument("--warmup-buckets", type=str, default=None,
                   help="comma list of B:S:T buckets to run before "
                        "accepting traffic (implies --warmup): declare the "
                        "shapes your traffic hits; the 'sample bucket' "
                        "lines of a traffic log name them")
    p.add_argument("--quantize", type=str, default=None, choices=("int8",),
                   help="weight-only int8: the weights live on the card "
                        "as int8 with per-channel scales and are expanded "
                        "one stack at a time during a sampling or vocoding "
                        "call; this halves the weight bytes held between "
                        "calls")
    p.add_argument("--platform", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="torch device; without CUDA the server fails "
                        "unless --platform cpu")
    p.add_argument("--bf16", action="store_true", default=True,
                   help="bf16 compute (f32 norms and vocoder head); always "
                        "on, as in the JAX server")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos
    from zipvoice_torch.utils.device import resolve_device

    device = resolve_device(args.platform)
    model, tokenizer = load_model_dir(args.model_dir, args.model_name,
                                      dtype=torch.bfloat16, device=device)
    vocoder = load_vocos(args.vocoder_path, dtype=torch.bfloat16,
                         device=device)
    pipeline = InferencePipeline(model, vocoder, device=device,
                                 tokenizer=tokenizer, quantize=args.quantize)
    engine = TTSEngine(
        pipeline, max_batch=args.max_batch, num_step=args.num_step,
        guidance_scale=args.guidance_scale,
    )
    if args.warmup_buckets:
        buckets = [tuple(int(x) for x in spec.strip().split(":"))
                   for spec in args.warmup_buckets.split(",")]
    elif args.warmup:
        # short (~5 s) and long (~10 s) requests after a 2-4 s prompt
        buckets = [(b, s, t) for b in warmup_batches(args.max_batch)
                   for s, t in ((64, 512), (64, 768), (128, 1024))]
    else:
        buckets = []
    for B, S, T in buckets:
        engine.warm(B, S, T)
    if buckets:
        logging.info(f"warmup done ({len(buckets)} buckets)")
    server = ThreadingHTTPServer(
        ("0.0.0.0", args.port), make_handler(engine, args.model_name)
    )
    logging.info(f"serving on :{args.port}")
    try:
        server.serve_forever()
    finally:
        server.server_close()
        engine.close()


if __name__ == "__main__":
    main()
