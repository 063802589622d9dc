"""gRPC TTS service: unary synthesis (micro-batched) + server streaming (the
port's counterpart of ``zipvoice_tpu/serving/grpc_server.py``).

Counterpart of the reference's Triton gRPC serving surface
(reference runtime/nvidia_triton/: model_repo TTS service + client_grpc.py
bench harness, including the decoupled/streaming mode).  Methods use JSON
requests and raw bytes responses over grpc's generic handler API — no
protoc code-gen step, the wire contract is the method table below.

Service ``/zipvoice.TTS/``:
  RegisterSpeaker   unary   {"name", "prompt_text", "wav_b64", "sr"} -> {"ok"}
  Synthesize        unary   {"speaker", "text", ["speed"]} -> WAV bytes
                            (routed through the micro-batching TTSEngine)
  SynthesizeStream  stream  {"speaker", "text", ["speed"]} -> int16 PCM
                            chunks as text chunks are synthesized (B=1,
                            lowest TTFB); first response metadata carries
                            sample_rate

An unknown speaker aborts the call with INVALID_ARGUMENT (3), a failed
synthesis with INTERNAL (13).  The handler class needs no grpc: the server
wraps its methods.

Run:  python -m zipvoice_torch.serving.grpc_server --model-dir DIR --port 50051
Bench: python -m zipvoice_torch.serving.client_grpc ...
"""

import argparse
import base64
import io
import json
import logging
import wave
from concurrent import futures

import numpy as np
import torch

from zipvoice_torch.serving.server import TTSEngine, _on_device, _wav_bytes

SERVICE = "zipvoice.TTS"
# gRPC status numbers the handler aborts with
INVALID_ARGUMENT = 3
INTERNAL = 13


def _ident(b):
    return b


def _abort(context, code: int, details: str):
    """Abort the call with the gRPC status numbered ``code``: as a
    ``grpc.StatusCode`` where grpc is installed (a server's context takes
    no other), else the number itself."""
    try:
        import grpc

        code = next(c for c in grpc.StatusCode if c.value[0] == code)
    except ImportError:
        pass
    context.abort(code, details)


class _TTSHandler:
    """Generic gRPC handler backed by TTSEngine (unary) + pipeline
    streaming.  A stream runs on the calling thread, in inference mode on
    the pipeline's device, beside the engine's threads."""

    def __init__(self, engine: TTSEngine, num_step: int,
                 guidance_scale: float):
        self.engine = engine
        self.num_step = num_step
        self.guidance_scale = guidance_scale

    # --- methods -----------------------------------------------------------

    def register(self, request: bytes, context) -> bytes:
        req = json.loads(request.decode())
        raw = base64.b64decode(req["wav_b64"])
        with wave.open(io.BytesIO(raw)) as f:
            sr = f.getframerate()
            n = f.getnframes()
            wav = np.frombuffer(
                f.readframes(n), np.int16
            ).astype(np.float32)[None] / 32768.0
        self.engine.cache.add(req["name"], req["prompt_text"], wav, sr)
        return json.dumps({"ok": True}).encode()

    def synthesize(self, request: bytes, context) -> bytes:
        req = json.loads(request.decode())
        entry = self.engine.cache.get(req["speaker"])
        if entry is None:
            _abort(context, INVALID_ARGUMENT,
                   f"unknown speaker {req['speaker']!r}")
        done = self.engine.submit(entry, req["text"],
                                  speed=float(req.get("speed", 1.0)))
        status, payload, _tm = done.get()
        if status != "ok":
            _abort(context, INTERNAL, payload)
        return _wav_bytes(payload, self.engine.pipeline.sampling_rate)

    def synthesize_stream(self, request: bytes, context):
        req = json.loads(request.decode())
        pipe = self.engine.pipeline
        entry = self.engine.cache.get(req["speaker"])
        if entry is None:
            _abort(context, INVALID_ARGUMENT,
                   f"unknown speaker {req['speaker']!r}")
        context.send_initial_metadata(
            (("sample-rate", str(pipe.sampling_rate)),)
        )
        with torch.inference_mode(), _on_device(pipe.device):
            for seg in pipe.generate_stream(
                entry["tokens"], entry["features"], req["text"],
                num_step=self.num_step, guidance_scale=self.guidance_scale,
                speed=float(req.get("speed", 1.0)),
                prompt_rms=entry["prompt_rms"],
            ):
                pcm = np.clip(seg[0], -1.0, 1.0)
                yield (pcm * 32767.0).astype("<i2").tobytes()


def make_server(engine: TTSEngine, port: int, num_step: int,
                guidance_scale: float, max_workers: int = 16):
    """(a grpc server of the three methods on ``port``, not started, the
    port it bound: ``port`` or, for 0, a free one)."""
    import grpc

    h = _TTSHandler(engine, num_step, guidance_scale)
    handlers = {
        "RegisterSpeaker": grpc.unary_unary_rpc_method_handler(
            h.register, request_deserializer=_ident,
            response_serializer=_ident,
        ),
        "Synthesize": grpc.unary_unary_rpc_method_handler(
            h.synthesize, request_deserializer=_ident,
            response_serializer=_ident,
        ),
        "SynthesizeStream": grpc.unary_stream_rpc_method_handler(
            h.synthesize_stream, request_deserializer=_ident,
            response_serializer=_ident,
        ),
    }
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=max_workers))
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(SERVICE, handlers),)
    )
    bound = server.add_insecure_port(f"[::]:{port}")
    return server, bound


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model-dir", type=str, required=True)
    p.add_argument("--model-name", type=str, default="zipvoice_distill")
    p.add_argument("--vocoder-path", type=str, default=None)
    p.add_argument("--port", type=int, default=50051)
    p.add_argument("--num-step", type=int, default=4)
    p.add_argument("--guidance-scale", type=float, default=3.0)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--engine-dir", type=str, default=None)
    p.add_argument("--quantize", type=str, default=None,
                   choices=(None, "int8"))
    p.add_argument("--platform", type=str, default="cuda",
                   choices=("cuda", "cpu"),
                   help="torch device; without CUDA the server fails "
                        "unless --platform cpu")
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
    if args.engine_dir:
        pipeline.attach_engines(args.engine_dir)
    engine = TTSEngine(pipeline, max_batch=args.max_batch,
                       num_step=args.num_step,
                       guidance_scale=args.guidance_scale)
    server, bound = make_server(engine, args.port, args.num_step,
                                args.guidance_scale)
    server.start()
    logging.info(f"gRPC serving on :{bound}")
    try:
        server.wait_for_termination()
    finally:
        server.stop(0)
        engine.close()


if __name__ == "__main__":
    main()
