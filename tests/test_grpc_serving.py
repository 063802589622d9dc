"""gRPC serving surface: register/synthesize/stream (tiny model, CPU)."""

import base64
import io
import json
import wave as wave_mod

import numpy as np
import pytest

import conftest  # noqa: F401

pytest.importorskip("grpc")
torch = pytest.importorskip("torch")

from test_serving import _wav_b64, tiny_model_dir  # noqa: F401,E402


def test_grpc_end_to_end(tiny_model_dir):  # noqa: F811
    import grpc

    from zipvoice_tpu.infer.pipeline import InferencePipeline
    from zipvoice_tpu.serving.grpc_server import make_server
    from zipvoice_tpu.serving.server import TTSEngine
    from zipvoice_tpu.utils.checkpoint_io import load_model_dir, load_vocos

    model, params, tokenizer = load_model_dir(str(tiny_model_dir), "zipvoice")
    vocoder, vp = load_vocos(None)
    pipeline = InferencePipeline(model, params, vocoder, vp, tokenizer)
    engine = TTSEngine(pipeline, max_batch=4, num_step=2, guidance_scale=1.0)
    server, port = make_server(engine, 0, num_step=2, guidance_scale=1.0)
    server.start()
    try:
        ident = lambda b: b  # noqa: E731
        channel = grpc.insecure_channel(f"localhost:{port}")
        register = channel.unary_unary(
            "/zipvoice.TTS/RegisterSpeaker", request_serializer=ident,
            response_deserializer=ident)
        synthesize = channel.unary_unary(
            "/zipvoice.TTS/Synthesize", request_serializer=ident,
            response_deserializer=ident)
        syn_stream = channel.unary_stream(
            "/zipvoice.TTS/SynthesizeStream", request_serializer=ident,
            response_deserializer=ident)

        sr = 24000
        rng = np.random.RandomState(0)
        prompt = (rng.randn(sr) * 0.05).astype(np.float32)
        resp = register(json.dumps({
            "name": "spk", "prompt_text": "hello there",
            "wav_b64": _wav_b64(prompt, sr),
        }).encode(), timeout=300)
        assert json.loads(resp)["ok"]

        body = synthesize(json.dumps({
            "speaker": "spk", "text": "a short test.",
        }).encode(), timeout=300)
        with wave_mod.open(io.BytesIO(bytes(body))) as f:
            assert f.getframerate() == sr
            n = f.getnframes()
            wav = np.frombuffer(f.readframes(n), np.int16)
        assert n > sr * 0.1 and np.isfinite(wav).all()

        # streaming: several PCM chunks that concatenate to a full wav
        chunks = list(syn_stream(json.dumps({
            "speaker": "spk",
            "text": "first sentence. second sentence. third one.",
        }).encode(), timeout=300))
        assert len(chunks) >= 1
        pcm = np.concatenate(
            [np.frombuffer(bytes(c), "<i2") for c in chunks]
        )
        assert pcm.size > sr * 0.1
        assert np.abs(pcm).max() > 0

        # unknown speaker -> INVALID_ARGUMENT
        with pytest.raises(grpc.RpcError):
            synthesize(json.dumps({
                "speaker": "nope", "text": "x",
            }).encode(), timeout=300)
    finally:
        server.stop(0)
