"""Port parity: serving (``zipvoice_torch.serving``: weight-only int8, the
speaker cache, the micro-batching engine, the HTTP/OpenAI server and the
bench client) against the JAX package's ``zipvoice_tpu.serving``, f32 on
the CPU, on a tiny ZipVoice-Distill model dir written by the port's
``bin/make_model_dir.py``.

The model has one fm_decoder layer, as the dialog files' models do (the
JAX side's traces of the layers dominate), at width 144 with a 31-tap
depthwise conv, so that int8 quantizes every kind of leaf: Linear weights,
a depthwise filter, the embedding and, in the Vocos, its input conv and
head.

Tolerances: quantized weights bitwise; the int8 sample within the
chained-CFG 5e-3 (5e-2 in the pipeline's mel units); prompt features within
the fbank tolerance of test_torch_frontend.py."""

import base64
import io
import json
import logging
import os
import threading
import urllib.error
import urllib.request
import wave

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from torch_parity import DS, fast_pipeline
from zipvoice_torch.bin.make_model_dir import (
    TINY_CONFIG,
    TINY_VOCOS,
    make_model_dir,
)
from zipvoice_torch.frontend.tokenizer import EmiliaTokenizer
from zipvoice_torch.infer.pipeline import InferencePipeline
from zipvoice_torch.infer.workload import speech_like_wav
from zipvoice_torch.models.zipvoice import build_zipvoice
from zipvoice_torch.serving import client, server
from zipvoice_torch.serving.quantize import (
    dequantize_state_dict,
    quantize_state_dict,
    quantized_bytes,
)
from zipvoice_torch.utils.checkpoint_io import load_torch_state_dict
from zipvoice_torch.utils.convert import (
    state_dict_from_jax_params,
    vocos_state_dict_from_jax_params,
)
from zipvoice_torch.vocoder.vocos import build_vocos

NAME = "zipvoice_distill"
CONFIG = dict(TINY_CONFIG, fm_decoder_downsampling_factor=[1],
              fm_decoder_num_layers=[1], fm_decoder_cnn_module_kernel=[31],
              fm_decoder_dim=144)
DS = dict(DS, fm_decoder=tuple(CONFIG["fm_decoder_downsampling_factor"]))
PROMPT_TEXT = "Hi, there, my friend."
# the server's defaults but for the steps
KW = dict(num_step=2, guidance_scale=3.0, t_shift=0.5)


@pytest.fixture(scope="module")
def side(tmp_path_factory):
    """The model dir, the JAX package's model, params, tokenizer and Vocos
    params through its own loaders, and the port's f32 pipeline on the
    CPU."""
    from zipvoice_tpu.utils.checkpoint_io import (
        load_model_dir as jax_load_model_dir,
    )
    from zipvoice_tpu.utils.checkpoint_io import load_vocos as jax_load_vocos

    d = tmp_path_factory.mktemp("serving")
    make_model_dir(str(d), NAME, config=CONFIG, seed=6,
                   vocos_config=TINY_VOCOS)
    jmodel, params, jtok = jax_load_model_dir(str(d), NAME)
    _, vparams = jax_load_vocos(str(d / "pytorch_model.bin"))
    return d, jmodel, params, jtok, vparams, _port_pipeline(d)


def _port_pipeline(d, **kw):
    """The port's f32 pipeline on the dir's weights and tokens, built
    without ``load_model_dir`` (held against JAX in
    test_torch_infer_cli.py), whose first call in a process imports
    seconds of torch for its meta-device build."""
    tok = EmiliaTokenizer(str(d / "tokens.txt"))
    model = build_zipvoice(distill=True, device="cpu",
                           vocab_size=tok.vocab_size, pad_id=tok.pad_id,
                           **CONFIG)
    model.load_state_dict(load_torch_state_dict(str(d / "model.pt")))
    vocos = build_vocos(device="cpu", **TINY_VOCOS)
    vocos.load_state_dict({
        k: v for k, v in load_torch_state_dict(
            str(d / "pytorch_model.bin")).items()
        if k.startswith(("backbone.", "head.out."))})
    return InferencePipeline(model, vocos, seed=5, device="cpu",
                             tokenizer=tok, **kw)


def _is_q(leaf):
    return isinstance(leaf, dict) and set(leaf) == {"q", "scale"}


def _invert(tree, fn, part):
    """The reference-layout tensors, through ``fn``, of a quantized flax
    tree with each quantized leaf replaced by its ``part``: "q", "scale",
    or "flag" (ones where the leaf is quantized, zeros elsewhere)."""
    def pick(leaf):
        if part == "flag":
            return np.full(np.shape(leaf["q"] if _is_q(leaf) else leaf),
                           float(_is_q(leaf)), np.float32)
        return leaf[part] if _is_q(leaf) else leaf

    return fn(jax.tree.map(pick, tree, is_leaf=_is_q))


def _assert_quantized_like_jax(sd, tree, fn):
    """``quantize_state_dict(sd)`` against the JAX package's
    ``quantize_params(tree)`` carried to the port's layout by ``fn``: the
    same keys quantized, int8 tensors and scales bitwise, the dequantized
    tensors bitwise in f32 and bf16."""
    from zipvoice_tpu.serving.quantize import dequantize_params, quantize_params

    got = quantize_state_dict(sd)
    want = quantize_params(tree)
    q, scale = _invert(want, fn, "q"), _invert(want, fn, "scale")
    quantized = {k for k, v in got.items() if isinstance(v, dict)}
    assert quantized == {k for k, v in _invert(want, fn, "flag").items()
                         if v.all()}
    assert quantized and len(quantized) < len(got)
    for k in quantized:
        assert got[k]["q"].dtype == torch.int8
        assert got[k]["scale"].dtype == torch.float32
        np.testing.assert_array_equal(got[k]["q"].numpy(), q[k])
        np.testing.assert_array_equal(got[k]["scale"].numpy(), scale[k])
    for k in set(got) - quantized:
        assert got[k] is sd[k]
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        d_want = fn(jax.tree.map(np.asarray, dequantize_params(want, jdt)))
        d_got = dequantize_state_dict(got, tdt)
        for k in quantized:
            assert d_got[k].dtype == tdt
            np.testing.assert_array_equal(d_got[k].float().numpy(),
                                          d_want[k])
    assert quantized_bytes(got) < 0.5 * quantized_bytes(sd)
    return quantized


def test_quantized_weights_match_jax(side):
    """(a) The model's and the Vocos's weights, quantized by the port in
    its layout, are the JAX package's quantized leaves, bit for bit: the
    kept axis is each flax leaf's last, whichever torch axis that is."""
    _, _, params, _, vparams, _ = side
    sd = state_dict_from_jax_params(params["params"], DS)
    quantized = _assert_quantized_like_jax(
        sd, params["params"],
        lambda t: state_dict_from_jax_params(t, DS))
    kinds = {"embed.weight", "fm_decoder.in_proj.weight",
             "fm_decoder.encoders.0.layers.0.conv_module1."
             "depthwise_conv.weight"}
    assert kinds <= quantized
    vsd = vocos_state_dict_from_jax_params(vparams["params"])
    vq = _assert_quantized_like_jax(vsd, vparams["params"],
                                    vocos_state_dict_from_jax_params)
    assert {"backbone.embed.weight", "head.out.weight"} <= vq


def test_int8_sample_matches_jax(side):
    """(b) ``_sample_batch`` with ``quantize="int8"`` against the JAX
    pipeline's on the same tokens, per-row prompts, speeds and seed: the
    same lengths, features within 5e-2 mel; and the int8 pipeline holds
    fewer weight bytes than the f32 one."""
    from zipvoice_tpu.infer.pipeline import InferencePipeline as JaxPipeline
    from zipvoice_tpu.vocoder.vocos import Vocos as JaxVocos

    d, jmodel, params, jtok, vparams, fpipe = side
    jpipe = fast_pipeline(JaxPipeline(jmodel, params, JaxVocos(**TINY_VOCOS),
                                      vparams, jtok, seed=5,
                                      quantize="int8"))
    tpipe = _port_pipeline(d, quantize="int8")
    rng = np.random.RandomState(2)
    V, F = jtok.vocab_size, CONFIG["feat_dim"]
    texts = [list(rng.randint(1, V, n)) for n in (30, 22)]
    prompts = [list(rng.randint(1, V, n)) for n in (12, 9)]
    feats = [(0.5 * rng.randn(n, F)).astype(np.float32) for n in (60, 41)]
    kw = dict(KW, speed=[1.0, 1.2])
    jf, jl = jpipe._sample_batch(texts, prompts, feats, **kw)
    tf, tl = tpipe._sample_batch(texts, prompts, feats, **kw)
    np.testing.assert_array_equal(tl, jl)
    for i, n in enumerate(jl):
        np.testing.assert_allclose(tf[i, :n], jf[i, :n], atol=5e-2, rtol=0)
    # the int8 weights move the features: the test would not see a
    # pipeline that ignored them
    fpipe.rng = np.random.RandomState(5)
    ff, _ = fpipe._sample_batch(texts, prompts, feats, **kw)
    assert np.abs(ff - tf).max() > 1e-3
    assert tpipe.weight_bytes() < 0.6 * fpipe.weight_bytes()
    # the quantized weights left the modules: nothing runs on stale ones
    assert tpipe.model.fm_decoder.in_proj.weight.device.type == "meta"


def test_int8_stack_expansion_equals_whole_copy(side):
    """(b2) The int8 pipeline, which expands its weights a stack at a time
    during a call, gives the bits of the same model run on a whole
    expanded copy of the int8 weights (the previous int8 path); between
    calls every quantized weight is a meta placeholder again."""
    d, *_, fpipe = side
    tpipe = _port_pipeline(d, quantize="int8")
    wpipe = _port_pipeline(d)
    for m in (wpipe.model, wpipe.vocoder):
        sd = m.state_dict()
        m.load_state_dict(dequantize_state_dict(
            quantize_state_dict(sd), {k: v.dtype for k, v in sd.items()}))
    rng = np.random.RandomState(7)
    V, F = wpipe.tokenizer.vocab_size, CONFIG["feat_dim"]
    texts = [list(rng.randint(1, V, n)) for n in (26, 17)]
    prompts = [list(rng.randint(1, V, n)) for n in (10, 8)]
    feats = [(0.5 * rng.randn(n, F)).astype(np.float32) for n in (50, 37)]
    got = tpipe._sample_batch(texts, prompts, feats, **KW, speed=1.0)
    want = wpipe._sample_batch(texts, prompts, feats, **KW, speed=1.0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    chunks = [got[0][i, :n] for i, n in enumerate(got[1])]
    for g, w in zip(tpipe._vocode_chunks(chunks),
                    wpipe._vocode_chunks(chunks)):
        np.testing.assert_array_equal(g, w)
    int8 = tpipe._int8[0]
    assert "" in int8.units and "fm_decoder.encoders.0" in int8.units
    assert all(p.device.type == "meta"
               for m in (tpipe.model, tpipe.vocoder)
               for n, p in m.named_parameters()
               if n in int8.weights or n in tpipe._int8[1].weights)


def _fbank_close(got, want, feat_scale):
    """test_torch_frontend.py's fbank tolerance on two log-mels scaled by
    ``feat_scale``: where the mel exceeds 1e-4, |d| <= 1e-4 + 2e-6 / mel."""
    g, w = got / feat_scale, want / feat_scale
    mel = np.exp(w)
    keep = mel > 1e-4
    d = np.abs(g - w)[keep]
    return float((d / (1e-4 + 2e-6 / mel[keep])).max())


@pytest.mark.parametrize("sr", [24000, 16000])
def test_speaker_cache_matches_jax(side, sr):
    """(c) ``SpeakerCache.add`` against the JAX package's on the same wav
    at 24 kHz and at 16 kHz (resampled to the pipeline's rate): features
    within the fbank tolerance, tokens, prompt rms and duration equal."""
    from zipvoice_tpu.infer.pipeline import InferencePipeline as JaxPipeline
    from zipvoice_tpu.serving.server import SpeakerCache as JaxSpeakerCache

    _, jmodel, params, jtok, _, tpipe = side
    wav = speech_like_wav(3, seconds=1.6, sr=sr)
    want = JaxSpeakerCache(JaxPipeline(jmodel, params, None, None, jtok)).add(
        "a", PROMPT_TEXT, wav, sr)
    cache = server.SpeakerCache(tpipe)
    got = cache.add("a", PROMPT_TEXT, wav, sr)
    assert cache.get("a") is got and cache.get("b") is None
    assert got["features"].shape == want["features"].shape
    assert _fbank_close(got["features"], want["features"], 0.1) <= 1.0
    assert got["tokens"] == want["tokens"]
    assert got["prompt_rms"] == want["prompt_rms"]
    assert got["duration"] == want["duration"]


def _entries(pipe):
    """Two speakers' cache entries with different prompts."""
    rs = np.random.RandomState(3)
    F = CONFIG["feat_dim"]
    return [
        {"tokens": pipe.tokenizer.texts_to_token_ids(["voice a."])[0],
         "features": (rs.randn(24, F) * 0.1).astype(np.float32),
         "prompt_rms": 0.15},
        {"tokens": pipe.tokenizer.texts_to_token_ids(["voice b here."])[0],
         "features": (rs.randn(32, F) * 0.1).astype(np.float32),
         "prompt_rms": 0.05},
    ]


def test_engine_batches_speakers_and_answers_errors(side):
    """(d) Two speakers' requests inside one batch window form ONE call of
    two rows with distinct prompt tokens (zipvoice_tpu's
    test_server_batches_across_speakers); a call that raises answers its
    request ("error", message, {}) and the engine answers the next one."""
    pipe = side[-1]
    calls = []
    orig = pipe._sample_batch_device
    fail = [True]

    def spy(batch_tokens, prompt_tokens, prompt_feats, **kw):
        calls.append((len(batch_tokens), prompt_tokens))
        if len(calls) == 2 and fail.pop():
            raise RuntimeError("injected")
        return orig(batch_tokens, prompt_tokens, prompt_feats, **kw)

    pipe._sample_batch_device = spy
    engine = server.TTSEngine(pipe, max_batch=2, batch_window_ms=2000.0,
                              num_step=2, guidance_scale=3.0)
    try:
        a, b = _entries(pipe)
        d1 = engine.submit(a, "short text one.")
        d2 = engine.submit(b, "short text two.")
        (s1, wav1, tm1), (s2, wav2, _) = d1.get(timeout=60), d2.get(
            timeout=60)
        assert s1 == s2 == "ok" and len(wav1) > 0 and len(wav2) > 0
        assert len(calls) == 1, calls
        n_rows, ptoks = calls[0]
        assert n_rows == 2 and isinstance(ptoks[0], list)
        assert ptoks[0] != ptoks[1]
        order = ("submit", "tokenized", "dispatch", "dispatched",
                 "device_done", "vocoded")
        assert all(tm1[x] <= tm1[y] for x, y in zip(order, order[1:]))

        engine.batch_window = 0.0  # one request a batch from here on
        assert engine.submit(a, "this one fails.").get(timeout=60) == (
            "error", "injected", {})
        status, wav, _ = engine.submit(b, "and this one works.").get(
            timeout=60)
        assert status == "ok" and np.isfinite(wav).all()
        assert len(calls) == 3
    finally:
        engine.close()
        del pipe._sample_batch_device
    assert not engine._sampler.is_alive() and not engine._finisher.is_alive()


def test_engine_warm_runs_on_its_own_threads(side):
    """``TTSEngine.warm`` samples on the engine's sampler thread and
    vocodes on its finisher thread, at the bucket it was given (B rows
    vocoded as one batch), and marks the bucket seen."""
    pipe = side[-1]
    where = []
    sample, vocode = pipe._warm_sample_device, pipe._vocode_chunks

    def spy_sample(*a, **k):
        where.append(("sample", threading.current_thread().name))
        return sample(*a, **k)

    def spy_vocode(chunks):
        where.append(("vocode", threading.current_thread().name, len(chunks)))
        return vocode(chunks)

    pipe._warm_sample_device, pipe._vocode_chunks = spy_sample, spy_vocode
    engine = server.TTSEngine(pipe, max_batch=2, num_step=1,
                              guidance_scale=3.0)
    try:
        engine.warm(2, 32, 256)
    finally:
        engine.close()
        del pipe._warm_sample_device, pipe._vocode_chunks
    assert where == [("sample", engine._sampler.name),
                     ("vocode", engine._finisher.name, 2)]
    assert (2, 32, 256) in pipe._seen_buckets


def test_engine_under_concurrent_load(side):
    """Many client threads, more than the cores, submitting to four
    speakers at once with a short switch interval: every request gets one
    reply, and its own: each wav is as long as its speaker's prompt and its
    text predict, which no other request's shares."""
    import sys

    pipe = side[-1]
    rs = np.random.RandomState(4)
    F = CONFIG["feat_dim"]
    entries = [{"tokens": list(rs.randint(3, 60, n_tok)),
                "features": (0.1 * rs.randn(n_feat, F)).astype(np.float32),
                "prompt_rms": 0.1}
               for n_tok, n_feat in ((10, 40), (12, 90), (8, 60), (9, 70))]
    texts = ["hi.", "we walked.", "the birds sang.", "a quiet river."]
    engine = server.TTSEngine(pipe, max_batch=8, batch_window_ms=5.0,
                              num_step=1, guidance_scale=3.0)
    replies = {}
    lock = threading.Lock()

    def want(e, t):
        pfl, ptl = e["features"].shape[0], len(e["tokens"])
        n = len(pipe.tokenizer.texts_to_token_ids([t])[0])
        return int(np.ceil(np.float32(pfl) / np.float32(ptl)
                           * np.float32(n))) * 256

    def client_thread(i):
        for j in range(2):
            k = (i + j) % 4
            status, wav, _ = engine.submit(entries[k], texts[k]).get(
                timeout=120)
            with lock:
                replies[(i, j)] = (status, len(wav), want(entries[k],
                                                          texts[k]))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client_thread, args=(i,))
                   for i in range(2 * (os.cpu_count() or 4))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        engine.close()
    assert len(replies) == 2 * len(threads)
    lengths = {w for _, _, w in replies.values()}
    assert len(lengths) == 4, lengths
    for status, got, w in replies.values():
        assert status == "ok" and got == w


def _b64_wav(wav, sr):
    return base64.b64encode(server._wav_bytes(wav, sr)).decode()


def test_http_routes(side, caplog):
    """(e) Every route and status code of the JAX server
    (zipvoice_tpu's test_server_end_to_end): health, models, speaker
    registration, /tts cached and inline with its phase split, the
    OpenAI speech route as wav and pcm, 404 for unknown speakers, voices
    and paths, 400 for bad JSON, missing fields and formats, 500 with the
    error when sampling fails; then the bench client against it."""
    pipe = side[-1]
    engine = server.TTSEngine(pipe, max_batch=4, num_step=2,
                              guidance_scale=3.0)
    httpd = server.ThreadingHTTPServer(
        ("127.0.0.1", 0), server.make_handler(engine, NAME))
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def call(path, obj=None, raw=None):
        data = raw if raw is not None else (
            None if obj is None else json.dumps(obj).encode())
        req = urllib.request.Request(
            url + path, data=data,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as r:
                return r.status, r.headers["Content-Type"], r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers["Content-Type"], e.read()

    def read_wav(data):
        with wave.open(io.BytesIO(data), "rb") as f:
            return (f.getframerate(), f.getnchannels(),
                    np.frombuffer(f.readframes(f.getnframes()), "<i2"))

    try:
        sr = 24000
        prompt = speech_like_wav(1, seconds=1.2)
        assert call("/health")[::2] == (200, b'{"status": "ok"}')
        code, _, body = call("/v1/models")
        assert code == 200
        assert json.loads(body)["data"][0]["id"] == NAME
        assert call("/nope")[0] == 404
        assert call("/speaker", {
            "name": "spk1", "prompt_text": PROMPT_TEXT,
            "prompt_wav_b64": _b64_wav(prompt[0], sr)})[::2] == (
            200, b'{"status": "ok"}')

        code, _, body = call("/tts", {"speaker": "spk1",
                                      "text": "a test sentence."})
        out = json.loads(body)
        assert code == 200 and out["sample_rate"] == sr
        assert out["audio_s"] > 0 and out["latency_s"] > 0
        assert set(out["timing"]) == {"tokenize_ms", "queue_ms",
                                      "sample_ms", "vocode_ms"}
        assert all(v >= 0 for v in out["timing"].values())
        rate, ch, pcm = read_wav(base64.b64decode(out["wav_b64"]))
        assert (rate, ch) == (sr, 1) and pcm.size == out["audio_s"] * sr

        # an inline prompt at 16 kHz goes through the resample path
        code, _, body = call("/tts", {
            "text": "another one.", "prompt_text": PROMPT_TEXT,
            "prompt_wav_b64": _b64_wav(speech_like_wav(2, 1.0, sr=16000)[0],
                                       16000)})
        assert code == 200 and json.loads(body)["audio_s"] > 0
        assert call("/tts", {"speaker": "nope", "text": "x"})[::2] == (
            404, b'{"error": "unknown speaker"}')
        assert call("/tts", raw=b"{not json")[::2] == (
            400, b'{"error": "bad json"}')
        code, _, body = call("/tts", {"text": "no prompt."})
        assert code == 400 and "prompt_wav_b64" in json.loads(body)["error"]

        code, ctype, body = call("/v1/audio/speech", {
            "model": NAME, "input": "openai style call.", "voice": "spk1",
            "response_format": "wav"})
        assert (code, ctype) == (200, "audio/wav")
        rate, ch, pcm = read_wav(body)
        assert (rate, ch) == (sr, 1) and pcm.size > 0
        code, ctype, body = call("/v1/audio/speech", {
            "input": "pcm please.", "voice": "spk1",
            "response_format": "pcm", "speed": 1.25})
        assert (code, ctype) == (200, "audio/pcm") and len(body) > 0
        for req, code_want, message in (
                ({"input": "x", "voice": "nope"}, 404, "unknown voice"),
                ({"input": "x"}, 400, "are required"),
                ({"input": "x", "voice": "spk1", "response_format": "mp3"},
                 400, "unsupported")):
            code, _, body = call("/v1/audio/speech", req)
            err = json.loads(body)["error"]
            assert code == code_want and message in err["message"]
            assert err["type"] == "invalid_request_error"

        orig = pipe._sample_batch_device
        pipe._sample_batch_device = lambda *a, **k: 1 / 0
        try:
            code, _, body = call("/tts", {"speaker": "spk1", "text": "x."})
            assert code == 500 and "division" in json.loads(body)["error"]
            code, _, body = call("/v1/audio/speech",
                                 {"input": "x.", "voice": "spk1"})
            assert code == 500
            assert json.loads(body)["error"]["type"] == "server_error"
        finally:
            pipe._sample_batch_device = orig

        # the bench client: two speakers, concurrency 1 and 2
        d = side[0]
        with open(d / "prompt.wav", "wb") as f:
            f.write(server._wav_bytes(prompt[0], sr))
        (d / "texts.txt").write_text("We walked home.\nThe birds sang.\n")
        with caplog.at_level(logging.INFO):
            client.main(["--url", url, "--prompt-wav", str(d / "prompt.wav"),
                         "--prompt-text", PROMPT_TEXT, "--text-file",
                         str(d / "texts.txt"), "--num-speakers", "2",
                         "--concurrency", "1,2", "--num-requests", "2"])
        lines = [r.getMessage() for r in caplog.records]
        for c in (1, 2):
            assert any(m.startswith(f"concurrency {c}: 2 requests")
                       and "P90" in m and "audio-s/s" in m for m in lines)
        assert sum("server phases" in m for m in lines) == 2
        assert engine.cache.get("bench1") is not None
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()


def test_client_prompt_prefixes_and_warmup_ladder(tmp_path):
    """The client's speakers are prefixes of 100%, 88%, 76%, 64% and 52%
    of the prompt, then again, never under half a second; the server warms
    every batch bucket up to --max-batch rounded up (the JAX server's
    ladder: --max-batch 6 warms B=8, never B=6)."""
    path = str(tmp_path / "p.wav")
    with open(path, "wb") as f:
        f.write(server._wav_bytes(np.zeros(24000, np.float32), 24000))
    lens = []
    for data in client.prompt_prefixes(path, 6):
        with wave.open(io.BytesIO(data), "rb") as f:
            lens.append(f.getnframes())
    assert lens == [24000, 21120, 18240, 15360, 12480, 24000]
    assert server.warmup_batches(6) == server.warmup_batches(8) == [
        1, 2, 4, 8]
    assert server.warmup_batches(1) == [1]


def test_server_main_without_cuda_needs_platform_cpu(side):
    """(f) The server runs on ``cuda`` by default: without CUDA and
    without ``--platform cpu``, ``main`` raises ``resolve_device``'s
    error before it loads anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="pass device='cpu'"):
        server.main(["--model-dir", os.fspath(side[0])])
