"""Port parity: the exported sampling engines (``serving/aot.py``,
``bin/export_model``, ``bin/infer_exported``, the pipeline's engine
dispatch), the diagnostics (``utils/diagnostics.py``, the trainer's
``--inf-check`` and ``--print-diagnostics``) and the token CLIs
(``bin/prepare_tokens``, ``bin/build_tokens``), against the JAX package
and the port's own eager path, on the CPU at TINY widths with 2 steps.

The engines are exported once for the file (a module-scoped fixture), from
a model of TINY widths whose decoder has one stack of one layer: export,
save and load cost seconds each on the CPU, in proportion to the graph."""

import json
import logging
import os
import sys
import zipfile

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

from test_torch_train_cli import _train, corpus  # noqa: F401
from torch_parity import TINY, jax_jit, model_pair
from torch_parity import one_torch_thread  # noqa: F401
from zipvoice_torch.models import zipformer
from zipvoice_torch.serving import aot

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_STEP = 2
# TINY widths, one decoder stack of one layer (as tests/test_torch_distill_
# train.py): the programs' nodes are mostly the decoder's
ONE_STACK = dict(fm_decoder_downsampling_factor=[1],
                 fm_decoder_num_layers=[1], fm_decoder_cnn_module_kernel=[7])
# one bucket for every case: infer_exported's prompt and text fit it, and
# the pipeline's request below snaps to it
BUCKET = (1, 64, 512)


def _bucket_inputs(B, S, T, feat_dim, vocab, seed=5):
    """Seeded inputs of ``sample`` at one bucket, as numpy: 6 text tokens
    and the trailing pad, a 10-frame prompt, 28 frames in all."""
    rng = np.random.RandomState(seed)
    tokens = np.zeros((B, S), np.int64)
    tokens[:, :6] = rng.randint(1, vocab, (B, 6))
    pf = np.zeros((B, T, feat_dim), np.float32)
    pf[:, :10] = rng.randn(B, 10, feat_dim)
    return dict(
        tokens=tokens, tokens_lens=np.full((B,), 7),
        prompt_tokens_lens=np.full((B,), 3), prompt_features=pf,
        prompt_features_lens=np.full((B,), 10),
        features_lens=np.full((B,), 28),
        noise=rng.randn(B, T, feat_dim).astype(np.float32),
    )


def _torch_args(inputs):
    return [torch.from_numpy(np.asarray(inputs[k])) for k in (
        "tokens", "tokens_lens", "prompt_tokens_lens", "prompt_features",
        "prompt_features_lens", "features_lens", "noise")]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """(flax model, flax params, port model, model dir, pipeline): a tiny
    model dir (100 mel bins, the Emilia vocabulary, a narrow Vocos, a 2 s
    prompt) holding ``model_pair``'s weights, its engines at ``BUCKET``
    written by ``bin/export_model``, attached to a pipeline of the port's
    model.  One export and one load serve the file: each costs seconds on
    the CPU."""
    from zipvoice_torch.bin import export_model
    from zipvoice_torch.bin.make_model_dir import (
        TINY_CONFIG,
        TINY_VOCOS,
        emilia_tokens,
        make_model_dir,
    )
    from zipvoice_torch.frontend.audio import save_wav
    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.infer.workload import speech_like_wav
    from zipvoice_torch.utils.checkpoint_io import load_vocos

    config = dict(TINY_CONFIG, **ONE_STACK)
    jmodel, params, port = model_pair(config=dict(
        config, vocab_size=len(emilia_tokens()), pad_id=0))
    out = tmp_path_factory.mktemp("model")
    make_model_dir(str(out), config=config, seed=4,
                   vocos_config=TINY_VOCOS)
    torch.save({"model": port.state_dict()}, out / "model.pt")
    save_wav(str(out / "prompt.wav"), speech_like_wav(7, seconds=2.0),
             24000)
    assert export_model.main([
        "--model-dir", str(out), "--out-dir", str(out / "eng"),
        "--buckets", ":".join(map(str, BUCKET)), "--num-step",
        str(NUM_STEP), "--platform", "cpu"]) == 0
    pipe = InferencePipeline(
        port, load_vocos(str(out / "pytorch_model.bin"), device="cpu"),
        device="cpu")
    pipe.attach_engines(str(out / "eng"))
    return jmodel, params, port, out, pipe


def test_engine_matches_eager_and_jax(exported, tmp_path):
    """The engine against the port's eager ``sample`` (1e-5, the same
    operations: tests/test_aot_export.py's bound) and against the JAX
    package's exported program on the same weights and inputs (5e-3)."""
    from zipvoice_tpu.serving.aot import export_sample_program, load_exported

    jmodel, params, port, _, pipe = exported
    inputs = _bucket_inputs(*BUCKET, port.feat_dim, port.embed.num_embeddings)
    args = _torch_args(inputs)
    with torch.inference_mode():
        x1, pm = pipe._engines[BUCKET](*args)
        want, want_pm = port.sample(*args, num_step=NUM_STEP,
                                    guidance_scale=1.0, t_shift=0.5)
    assert torch.equal(pm, want_pm)
    np.testing.assert_allclose(x1.numpy(), want.numpy(), atol=1e-5, rtol=0)

    manifest = export_sample_program(jmodel, params, str(tmp_path),
                                     buckets=[BUCKET], num_step=NUM_STEP)
    fn = load_exported(str(tmp_path / manifest["buckets"][0]["file"]))
    jx1, jpm = jax_jit(fn)(params, *[
        jnp.asarray(v, jnp.int32 if v.dtype == np.int64 else jnp.float32)
        for v in (inputs[k] for k in (
            "tokens", "tokens_lens", "prompt_tokens_lens", "prompt_features",
            "prompt_features_lens", "features_lens", "noise"))])
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jpm))
    valid = ~pm.numpy()
    np.testing.assert_allclose(x1.numpy()[valid], np.asarray(jx1)[valid],
                               atol=5e-3, rtol=0)


def test_engine_follows_the_weights_it_is_given(exported):
    """No engine file holds the weights: the tensors stored in the
    archives are a small fraction of the weights' bytes, and after the
    model's weights change in place the engine equals eager sampling on
    the new ones."""
    _, _, port, out, pipe = exported
    engine = pipe._engines[BUCKET]
    out = out / "eng"
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in port.parameters())
    for name in os.listdir(out):
        if name.endswith(".pt2"):
            # a .pt2 is a zip archive; tensors live under data/
            with zipfile.ZipFile(os.path.join(out, name)) as z:
                stored = sum(i.file_size for i in z.infolist()
                             if "/data/" in i.filename
                             and not i.filename.endswith(".json"))
            assert stored < 0.01 * weight_bytes, (name, stored)
    args = _torch_args(_bucket_inputs(*BUCKET, port.feat_dim,
                                      port.embed.num_embeddings))
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    gen = torch.Generator().manual_seed(1)
    try:
        with torch.inference_mode():
            before, _ = engine(*args)
        with torch.no_grad():
            for p in port.parameters():
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
        with torch.inference_mode():
            got, _ = engine(*args)
            want, _ = port.sample(*args, num_step=NUM_STEP,
                                  guidance_scale=1.0, t_shift=0.5)
    finally:
        port.load_state_dict(saved)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert (got - before).abs().max() > 1e-2


@pytest.mark.parametrize("kernel_config", [False, True])
def test_programs_hold_the_kernel_operators(kernel_config, monkeypatch):
    """With the gates patched down (as tests/test_torch_attention.py does),
    the traced programs call the kernels' operators: #1's in the default
    configuration; #2's, #3's and #6's, and not #1's, in the kernel
    configuration."""
    from zipvoice_torch.models.zipvoice import build_zipvoice

    monkeypatch.setattr(zipformer, "MIN_SEQ_LEN", 8)
    monkeypatch.setattr(zipformer, "MIN_APPLY_SEQ_LEN", 8)
    port = build_zipvoice(device="cpu", **TINY)
    zipformer.set_kernel_config(port, kernel_config)
    # the condition program alone: the text encoder's layer at S = 8 holds
    # every kernel's call site, as the fm_decoder's layers do
    name, ep = next(aot.trace_programs(port, 1, 8, 16, guidance_scale=1.0))
    assert name == "condition"
    ops = {str(n.target) for n in ep.graph.nodes
           if str(n.target).startswith("zipvoice.")}
    assert ops == ({"zipvoice.rel_pos_attention_weights_nonlin.default",
                    "zipvoice.attention_apply.default",
                    "zipvoice.depthwise_conv1d.default"} if kernel_config
                   else {"zipvoice.rel_pos_attention_weights.default"})


def test_wrappers_take_the_operator_only_when_traced(monkeypatch):
    """Outside tracing each inference wrapper calls its implementation
    itself (a ``torch.ops`` call costs the dispatcher's Python layers on a
    host-bound path): with the operators made to raise, the wrappers still
    give the plain versions' outputs.  Under torch.export's fake tensors
    ``untraced`` is false, so a traced call takes the operator."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from zipvoice_torch.kernels import _build
    from zipvoice_torch.kernels import depthwise_conv as dc
    from zipvoice_torch.kernels import rel_pos_attention as ra

    def no_operator(*_):
        raise AssertionError("the eager path must not call the operator")

    for module, name in ((ra, "_weights_op"), (ra, "_nonlin_op"),
                         (ra, "_apply_op"), (dc, "_conv_op")):
        monkeypatch.setattr(module, name, no_operator)
    g = torch.Generator().manual_seed(0)
    B, h, T = 1, 4, 8
    q, k = (torch.randn(B, h, T, 8, generator=g) for _ in range(2))
    p = torch.randn(B, h, T, 4, generator=g)
    pe = torch.randn(h, 2 * T - 1, 4, generator=g)
    mask = torch.arange(T)[None] >= 6
    nv = torch.randn(B, T, 48, generator=g)
    v = torch.randn(B, h, T, 12, generator=g)
    x, w, b = (torch.randn(2, T, 16, generator=g),
               torch.randn(16, 7, generator=g), torch.randn(16, generator=g))
    weights = ra.rel_pos_attention_weights(q, k, p, pe, mask)
    assert torch.equal(weights,
                       ra.rel_pos_attention_weights_ref(q, k, p, pe, mask))
    for got, want in zip(
            ra.rel_pos_attention_weights_nonlin(q, k, p, pe, mask, nv),
            ra.rel_pos_attention_weights_nonlin_ref(q, k, p, pe, mask, nv)):
        assert torch.equal(got, want)
    assert torch.equal(ra.attention_apply(weights, v),
                       ra.attention_apply_ref(weights, v))
    assert torch.equal(dc.depthwise_conv1d(x, w, b),
                       dc.depthwise_conv1d_ref(x, w, b))
    assert _build.untraced(q)
    with FakeTensorMode() as mode:
        assert not _build.untraced(mode.from_tensor(q))


def test_infer_exported_cli(exported, tmp_path):
    """``bin/export_model`` then ``bin/infer_exported`` in process: a 24
    kHz mono wav of the generated frames, finite, within [-1, 1]."""
    from zipvoice_torch.bin import infer_exported
    from zipvoice_torch.frontend.audio import load_wav

    model_dir = exported[3]
    manifest = json.loads((model_dir / "eng" / "manifest.json").read_text())
    assert manifest["num_step"] == NUM_STEP
    assert manifest["dtype"] == "torch.float32"
    out = tmp_path / "out.wav"
    assert infer_exported.main([
        "--engine-dir", str(model_dir / "eng"), "--model-dir",
        str(model_dir), "--vocoder-path",
        str(model_dir / "pytorch_model.bin"), "--prompt-wav",
        str(model_dir / "prompt.wav"), "--prompt-text", "Hi, there.",
        "--text", "We walked home.", "--res-wav-path", str(out),
        "--platform", "cpu"]) == 0
    wav = load_wav(str(out), 24000)
    assert wav.shape[0] == 1 and 0.1 * 24000 < wav.shape[1] < 6 * 24000
    assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0


@pytest.mark.parametrize("cli", ["export_model", "infer_exported"])
def test_engine_clis_want_cuda_by_default(cli, tmp_path):
    """Without ``--platform`` the engine CLIs run on CUDA, and without a
    card they fail with ``resolve_device``'s message before any work."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    main = importlib.import_module(f"zipvoice_torch.bin.{cli}").main
    argv = {"export_model": ["--model-dir", str(tmp_path), "--out-dir",
                             str(tmp_path / "eng")],
            "infer_exported": ["--engine-dir", str(tmp_path / "eng"),
                               "--model-dir", str(tmp_path), "--prompt-wav",
                               "p.wav", "--prompt-text", "a",
                               "--text", "b"]}[cli]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    assert not (tmp_path / "eng").exists()


def test_pipeline_engine_dispatch(exported, caplog):
    """tests/test_aot_export.py's dispatch case: a bucket the engines hold
    is served by them, with the model's sampling made to raise, equal to
    the model's path; another ``num_step`` misses, logged, and samples on
    the model's path; engines exported in another kernel configuration
    are refused."""
    from zipvoice_torch.infer.pipeline import InferencePipeline

    _, _, port, out, pipe = exported
    out = out / "eng"
    rng = np.random.RandomState(7)
    # 40 text + 5 prompt tokens (+1) -> S 64; 50 + ceil(50/5*40) = 450
    # frames -> T 512
    vocab = port.embed.num_embeddings
    text = [list(rng.randint(1, vocab, 40))]
    prompt = list(rng.randint(1, vocab, 5))
    feats = rng.randn(50, port.feat_dim).astype(np.float32)
    kw = dict(num_step=NUM_STEP, guidance_scale=1.0, speed=1.0, t_shift=0.5)

    ref = InferencePipeline(port, pipe.vocoder, seed=0, device="cpu")
    want = ref._sample_batch(text, prompt, feats, **kw)

    def no_sampling(*_, **__):
        raise AssertionError("the model's sampling must not run")

    pipe.rng = np.random.RandomState(0)
    hits, misses = pipe.engine_hits, pipe.engine_misses
    original, pipe._run_model = pipe._run_model, no_sampling
    try:
        got = pipe._sample_batch(text, prompt, feats, **kw)
    finally:
        pipe._run_model = original
    np.testing.assert_array_equal(got[1], want[1])
    # in mel units: the features are scaled by 1/0.1
    np.testing.assert_allclose(got[0], want[0], atol=1e-5 / 0.1, rtol=0)
    assert (pipe.engine_hits, pipe.engine_misses) == (hits + 1, misses)

    with caplog.at_level(logging.INFO):
        miss = pipe._sample_batch(text, prompt, feats,
                                  **dict(kw, num_step=1))
    assert np.isfinite(miss[0]).all()
    assert pipe.engine_misses == misses + 1
    assert any("engine miss" in r.message for r in caplog.records)

    zipformer.set_kernel_config(port, True)
    try:
        with pytest.raises(ValueError, match="kernel_switches"):
            ref.attach_engines(out)
    finally:
        zipformer.set_kernel_config(port, False)
    # a weight of another dtype is named too
    manifest = json.loads((out / "manifest.json").read_text())
    manifest["weights"][0][2] = "torch.bfloat16"
    with pytest.raises(ValueError, match="weights differ"):
        aot.check_traced_state(manifest, port)


def test_server_warms_engines_and_reports_hits(exported):
    """``TTSEngine.warm`` at an engine's bucket runs it on the engine's
    threads (a hit), and ``/health`` reports the hits and misses when
    engines are attached."""
    import threading
    import urllib.request

    from zipvoice_torch.serving import server

    pipe = exported[4]
    hits = pipe.engine_hits
    engine = server.TTSEngine(pipe, max_batch=1, num_step=NUM_STEP,
                              guidance_scale=1.0)
    httpd = server.ThreadingHTTPServer(("127.0.0.1", 0),
                                       server.make_handler(engine))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        engine.warm(*BUCKET, timeout=120)
        url = f"http://127.0.0.1:{httpd.server_address[1]}/health"
        with urllib.request.urlopen(url, timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
    assert health == {"status": "ok", "engine_hits": hits + 1,
                      "engine_misses": pipe.engine_misses}


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(7, 5, 6).astype(np.float32),
            rng.randn(3, 600).astype(np.float32),
            rng.randn(40).astype(np.float32) ** 3]


def test_diagnostics_match_jax():
    """``_stats``, ``dimwise_stats`` and ``find_nonfinite`` equal the JAX
    package's on the same seeded arrays (and on torch tensors of them)."""
    from zipvoice_torch.utils import diagnostics as td
    from zipvoice_tpu.utils import diagnostics as jd

    for x in _arrays():
        for got_x in (x, torch.from_numpy(x)):
            assert td._stats(got_x) == jd._stats(x)
            got, want = td.dimwise_stats(got_x), jd.dimwise_stats(x)
            assert got.keys() == want.keys()
            for d in want:
                assert got[d].keys() == want[d].keys()
                for k in want[d]:
                    np.testing.assert_array_equal(got[d][k], want[d][k])
    tree = {"a": {"w": _arrays()[0].copy(), "n": np.arange(4)},
            "b": _arrays()[1].copy()}
    tree["a"]["w"][0, 0, :2] = [np.inf, np.nan]
    tree["b"][1, 5] = -np.inf
    want = jd.find_nonfinite(tree, prefix="p/")
    assert want == {"p/a/w": 2, "p/b": 1}
    assert td.find_nonfinite(tree, prefix="p/") == want
    as_torch = {"a": {k: torch.from_numpy(v) for k, v in tree["a"].items()},
                "b": torch.from_numpy(tree["b"])}
    assert td.find_nonfinite(as_torch, prefix="p/") == want
    clean = {"a": {"w": _arrays()[0]}, "b": _arrays()[2]}
    assert td.format_stats(td.collect_tree_stats(clean)) == jd.format_stats(
        jd.collect_tree_stats(clean))


def test_inf_check_names_the_module(corpus, tmp_path, capsys):  # noqa: F811
    """``--inf-check``: with an inf injected into one weight, the first
    step's loss is non-finite and the trainer stops, naming that weight's
    module first among those whose outputs are non-finite.  Then
    ``--print-diagnostics`` prints the three dumps on one batch and
    trains nothing."""
    from zipvoice_torch.bin.train_zipvoice import build_model, get_parser
    from zipvoice_torch.frontend.tokenizer import get_tokenizer
    from zipvoice_torch.utils.checkpoint_io import save_checkpoint

    _, manifest, tokens, cfg = corpus
    args = get_parser().parse_args([
        "--train-manifest", manifest, "--token-file", tokens, "--tokenizer",
        "simple", "--model-config", cfg, "--exp-dir", str(tmp_path)])
    model, _ = build_model(args, get_tokenizer("simple", tokens),
                           torch.float32, "cpu")
    target = "fm_decoder.encoders.0.layers.0.feed_forward1.in_proj"
    sd = model.state_dict()
    sd[target + ".weight"][0, 0] = float("inf")
    save_checkpoint(str(tmp_path / "bad"), sd)
    with pytest.raises(RuntimeError, match="non-finite loss") as err:
        _train(corpus, tmp_path / "exp", "--num-epochs", "1",
               "--checkpoint", str(tmp_path / "bad"), "--inf-check")
    assert f"['{target}'" in str(err.value)

    assert _train(corpus, tmp_path / "diag", "--num-epochs", "1",
                  "--print-diagnostics") == []
    printed = capsys.readouterr().out
    for section in ("module outputs", "parameters", "parameter grads"):
        assert f"==== {section} ====" in printed
    assert "fm_decoder.encoders.0.layers.0.self_attn_weights " in printed


def test_token_clis_match_jax(tmp_path, monkeypatch):
    """``bin/prepare_tokens`` and ``bin/build_tokens`` write the files the
    JAX package's write, on the same manifest."""
    from zipvoice_torch.bin import build_tokens, prepare_tokens
    from zipvoice_torch.data.manifest import Cut, write_manifest
    from zipvoice_tpu.bin import build_tokens as jax_build
    from zipvoice_tpu.bin import prepare_tokens as jax_prepare

    cuts = [Cut(id=f"c{i}", text=t, duration=1.0) for i, t in enumerate(
        ["Hello world, my friend.", "The birch canoe slid.",
         "Numbers like 42 read aloud!"])]
    for side in ("port", "jax"):
        write_manifest(str(tmp_path / f"{side}.jsonl"), cuts)
    assert prepare_tokens.main(["--manifest",
                                str(tmp_path / "port.jsonl")]) == 0
    assert build_tokens.main(["--manifest", str(tmp_path / "port.jsonl"),
                              "--output", str(tmp_path / "port.txt"),
                              "--extra-tokens", "[S1],[S2]"]) == 0
    for module, argv in (
            (jax_prepare, ["--manifest", str(tmp_path / "jax.jsonl")]),
            (jax_build, ["--manifest", str(tmp_path / "jax.jsonl"),
                         "--output", str(tmp_path / "jax.txt"),
                         "--extra-tokens", "[S1],[S2]"])):
        monkeypatch.setattr(sys, "argv", ["prog", *argv])
        module.main()
    for ext in ("jsonl", "txt"):
        got = (tmp_path / f"port.{ext}").read_text()
        assert got == (tmp_path / f"jax.{ext}").read_text(), ext
    assert len((tmp_path / "port.txt").read_text().splitlines()) > 10
