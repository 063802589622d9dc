"""The port's gRPC pair (``zipvoice_torch/serving/grpc_server.py`` and
``client_grpc.py``) against the JAX package's, f32 on the CPU, on a tiny
model dir written by the port's ``bin/make_model_dir.py`` (the one-layer
ZipVoice-Distill of tests/test_torch_serving.py).

- tests/test_grpc_serving.py's scenario over the wire: register a speaker,
  a unary Synthesize (a 24 kHz WAV), a SynthesizeStream of three sentences
  (PCM chunks), and an unknown speaker, which aborts with INVALID_ARGUMENT;
- the service name and the method table (names, unary or streaming) equal
  the JAX server's, and the client's service name equals its;
- Synthesize over the wire returns the bytes of the port's ``TTSEngine``
  output for the same request, speaker and seed;
- the client's percentiles are ``np.percentile``'s (JAX's index rule
  differs on the case below), and its sweep and streaming TTFB run
  against the server.
"""

import base64
import io
import json
import wave

import numpy as np
import pytest

import conftest  # noqa: F401

from test_torch_serving import CONFIG, NAME, PROMPT_TEXT, _port_pipeline
from torch_parity import one_torch_thread  # noqa: F401
from zipvoice_torch.bin.make_model_dir import TINY_VOCOS, make_model_dir
from zipvoice_torch.frontend.audio import save_wav
from zipvoice_torch.serving import client_grpc, grpc_server
from zipvoice_torch.serving.server import (
    TTSEngine,
    _decode_wav_b64,
    _wav_bytes,
)

grpc = pytest.importorskip("grpc")

SR = 24000
KW = dict(num_step=2, guidance_scale=1.0)

# the engines' threads share torch's one intra-op thread: beside JAX's
# pool, more make the tiny model's small ops slower
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _ident(b):
    return b


def _prompt(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(SR) * 0.05).astype(np.float32)


def _register_request(name="spk"):
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SR)
        f.writeframes((np.clip(_prompt(), -1, 1) * 32767).astype(
            np.int16).tobytes())
    return json.dumps({"name": name, "prompt_text": PROMPT_TEXT,
                       "wav_b64": base64.b64encode(buf.getvalue()).decode()
                       }).encode()


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("grpc")
    make_model_dir(str(d), NAME, config=CONFIG, seed=6,
                   vocos_config=TINY_VOCOS)
    return d


@pytest.fixture(scope="module")
def served(model_dir):
    """(the engine, the port's server on a free port, a channel to it)."""
    engine = TTSEngine(_port_pipeline(model_dir), max_batch=4, **KW)
    server, port = grpc_server.make_server(engine, 0, **KW)
    server.start()
    channel = grpc.insecure_channel(f"localhost:{port}")
    try:
        yield engine, port, channel
    finally:
        channel.close()
        server.stop(0)
        engine.close()


def _methods(channel):
    return {m: (channel.unary_stream if m == "SynthesizeStream"
                else channel.unary_unary)(
        f"/{grpc_server.SERVICE}/{m}", request_serializer=_ident,
        response_deserializer=_ident)
        for m in ("RegisterSpeaker", "Synthesize", "SynthesizeStream")}


def test_grpc_end_to_end(served):
    _, _, channel = served
    rpc = _methods(channel)
    assert json.loads(rpc["RegisterSpeaker"](_register_request(),
                                              timeout=300))["ok"]

    body = rpc["Synthesize"](json.dumps({
        "speaker": "spk", "text": "a short test."}).encode(), timeout=300)
    with wave.open(io.BytesIO(bytes(body))) as f:
        assert (f.getframerate(), f.getnchannels()) == (SR, 1)
        n = f.getnframes()
        wav = np.frombuffer(f.readframes(n), np.int16)
    assert n > SR * 0.1 and np.isfinite(wav).all()

    chunks = list(rpc["SynthesizeStream"](json.dumps({
        "speaker": "spk",
        "text": "first sentence. second sentence. third one."}).encode(),
        timeout=300))
    assert len(chunks) >= 1
    pcm = np.concatenate([np.frombuffer(bytes(c), "<i2") for c in chunks])
    assert pcm.size > SR * 0.1 and np.abs(pcm).max() > 0

    for method in ("Synthesize", "SynthesizeStream"):
        with pytest.raises(grpc.RpcError) as e:
            list(rpc[method](json.dumps({"speaker": "nope",
                                         "text": "x"}).encode(),
                                timeout=300))
        assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_method_table_and_service_match_jax(monkeypatch):
    from zipvoice_tpu.serving import client_grpc as jax_client
    from zipvoice_tpu.serving import grpc_server as jax_server

    tables = []
    make = grpc.method_handlers_generic_handler

    def record(service, handlers):
        tables.append((service, {
            name: (h.request_streaming, h.response_streaming)
            for name, h in handlers.items()}))
        return make(service, handlers)

    monkeypatch.setattr(grpc, "method_handlers_generic_handler", record)
    for make_server in (jax_server.make_server, grpc_server.make_server):
        server, _ = make_server(None, 0, 2, 1.0)
        server.stop(0)
    assert tables[0] == tables[1]
    assert tables[1][0] == grpc_server.SERVICE == jax_server.SERVICE
    assert tables[1][1]["SynthesizeStream"] == (False, True)
    assert client_grpc.SERVICE == jax_client.SERVICE
    assert client_grpc._TEXTS == jax_client._TEXTS


def test_synthesize_equals_engine_output(model_dir):
    """The same request on two fresh pipelines of one seed: over the wire,
    and straight through ``TTSEngine.submit``."""
    text = "we walked home."
    engines = [TTSEngine(_port_pipeline(model_dir), max_batch=4, **KW)
               for _ in range(2)]
    server, port = grpc_server.make_server(engines[0], 0, **KW)
    server.start()
    try:
        with grpc.insecure_channel(f"localhost:{port}") as channel:
            rpc = _methods(channel)
            rpc["RegisterSpeaker"](_register_request(), timeout=300)
            body = rpc["Synthesize"](json.dumps({
                "speaker": "spk", "text": text}).encode(), timeout=300)
        # the prompt as the wire carries it, 16-bit
        wav, sr = _decode_wav_b64(json.loads(_register_request())["wav_b64"])
        entry = engines[1].cache.add("spk", PROMPT_TEXT, wav, sr)
        status, wav, _ = engines[1].submit(entry, text).get(timeout=300)
        assert status == "ok"
        assert bytes(body) == _wav_bytes(wav, SR)
    finally:
        server.stop(0)
        for engine in engines:
            engine.close()


def test_client_percentiles_and_sweep(served, tmp_path, capsys):
    # 10 latencies: JAX's index rule reads P90 as the largest, 1.0
    lats = [0.1 * i for i in range(1, 10)] + [1.0]
    point = client_grpc.sweep_point(2, lats, audio_s=3.0, wall=1.5)
    assert point["p90"] == round(float(np.percentile(lats, 90)), 3) == 0.91
    assert point["p50"] == 0.55 and point["audio_s_per_s"] == 2.0

    _, port, _ = served
    prompt = str(tmp_path / "prompt.wav")
    save_wav(prompt, _prompt()[None], SR)
    client_grpc.main(["--target", f"localhost:{port}", "--prompt-wav",
                      prompt, "--prompt-text", PROMPT_TEXT,
                      "--concurrency", "1,2", "--n", "3", "--stream"])
    points = [json.loads(line) for line in
              capsys.readouterr().out.strip().splitlines()]
    assert [p["concurrency"] for p in points] == [1, 2]
    for p in points:
        assert 0 < p["p50"] <= p["p90"] <= p["p99"]
        assert p["n"] == 3 and p["audio_s_per_s"] > 0
    assert 0 < points[0]["ttfb_p50"] <= points[0]["stream_total_p50"]
