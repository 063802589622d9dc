"""Port parity: ``load_model_dir``, ``load_vocos``, the pipeline's text and
wav entry points (``generate_sentence``, ``generate_raw``,
``generate_stream``) and the ``bin/infer_zipvoice`` CLI, against the JAX
package on a tiny random model dir written by the port's
``bin/make_model_dir.py`` (100 mel bins, a narrow Vocos)."""

import os
import subprocess
import sys

import numpy as np
import pytest

import conftest  # noqa: F401

import torch

from torch_parity import DS, fast_pipeline, one_torch_thread  # noqa: F401
from zipvoice_torch.bin.make_model_dir import (
    TINY_CONFIG,
    TINY_VOCOS,
    make_model_dir,
)
from zipvoice_torch.frontend.audio import save_wav
from zipvoice_torch.infer.pipeline import InferencePipeline
from zipvoice_torch.infer.workload import speech_like_wav
from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos
from zipvoice_torch.utils.convert import (
    state_dict_from_jax_params,
    vocos_state_dict_from_jax_params,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT_TEXT = "Hi, there, my friend."
# Two sentences, each a chunk of its own: a tag unknown to the vocabulary
# is one token toward the chunk budget (about 25 s of speech at the
# prompt's token rate) but has no id, so the chunks split as they would on
# a long text while the frame buckets stay small.
FIRST = "[breath]" * 140 + " We walked home."
TEXT = FIRST + " " + "[breath]" * 140 + " The birds sang."


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("model")
    make_model_dir(str(out), config=TINY_CONFIG, seed=4,
                   vocos_config=TINY_VOCOS)
    save_wav(str(out / "prompt.wav"), speech_like_wav(7, seconds=2.0),
             24000)
    return out


@pytest.fixture(scope="module")
def jax_side(model_dir):
    """The JAX package's model and tokenizer through its own
    ``load_model_dir``, and its Vocos built at the file's narrow widths."""
    from zipvoice_tpu.utils.checkpoint_io import (
        load_model_dir as jax_load_model_dir,
    )
    from zipvoice_tpu.utils.checkpoint_io import load_vocos as jax_load_vocos
    from zipvoice_tpu.vocoder.vocos import Vocos as JaxVocos

    model, params, tokenizer = jax_load_model_dir(str(model_dir))
    _, vocos_params = jax_load_vocos(str(model_dir / "pytorch_model.bin"))
    return model, params, tokenizer, JaxVocos(**TINY_VOCOS), vocos_params


def test_load_model_dir_matches_jax(model_dir, jax_side):
    """Both packages read the same weights, tensor for tensor."""
    _, params, jtok, _, vocos_params = jax_side
    model, tok = load_model_dir(str(model_dir), device="cpu")
    assert (tok.vocab_size, tok.pad_id) == (jtok.vocab_size, jtok.pad_id)
    want = state_dict_from_jax_params(params["params"], DS)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    vocos = load_vocos(str(model_dir / "pytorch_model.bin"), device="cpu")
    want = vocos_state_dict_from_jax_params(vocos_params["params"])
    got = vocos.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k

    bf16, _ = load_model_dir(str(model_dir), dtype=torch.bfloat16,
                             device="cpu")
    for name, p in bf16.named_parameters():
        if name.endswith(".weight") and p.dim() >= 2 and "embed." != name[:6]:
            assert p.dtype == torch.bfloat16, name
    # the dialog models need [S1] and [S2], which the base vocabulary
    # lacks (bin/make_model_dir.py --model-name zipvoice_dialog adds them)
    with pytest.raises(KeyError, match=r"\[S1\]"):
        load_model_dir(str(model_dir), "zipvoice_dialog", device="cpu")


def test_load_distill_and_safetensors_match_jax(tmp_path):
    """A ZipVoiceDistill dir (its guidance-scale embedding included), read
    from ``model.pt`` and, with the same weights, from
    ``model.safetensors``: both packages load the same tensors."""
    from safetensors.torch import save_file

    from zipvoice_tpu.utils.checkpoint_io import (
        load_model_dir as jax_load_model_dir,
    )

    pt, st = tmp_path / "pt", tmp_path / "st"
    make_model_dir(str(pt), "zipvoice_distill", config=TINY_CONFIG, seed=2)
    model, _ = load_model_dir(str(pt), "zipvoice_distill", device="cpu")
    assert model.use_guidance_scale_embed
    _, params, _ = jax_load_model_dir(str(pt), "zipvoice_distill")
    want = state_dict_from_jax_params(params["params"], DS)
    st.mkdir()
    for name in ("model.json", "tokens.txt"):
        (st / name).write_bytes((pt / name).read_bytes())
    save_file(model.state_dict(), str(st / "model.safetensors"))
    again, _ = load_model_dir(str(st), "zipvoice_distill", device="cpu")
    for got in (model.state_dict(), again.state_dict()):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def _recording(pipe, log):
    """Wrap ``pipe._sample_batch`` to keep each micro-batch's features."""
    inner = pipe._sample_batch

    def run(*args, **kwargs):
        feats, lens = inner(*args, **kwargs)
        log.extend(np.array(feats[i, :n]) for i, n in enumerate(lens))
        return feats, lens

    pipe._sample_batch = run


# wav tolerance: the two vocoders agree to 1e-4 on the same mel
# (test_torch_vocos.py), and the mels they get here differ by the chained
# sampling's f32 drift (7.6e-5 in mel units at the time of writing); the
# silence trim of generate_sentence works on the 16-bit samples, so there
# a sample near a rounding boundary may also differ by one step, 2^-15
# (measured: 3.1e-5 on generate_sentence's wav, below 2e-7 on the others)
WAV_ATOL = 1e-4


def test_generate_paths_match_jax(model_dir, jax_side):
    """``generate_sentence``, ``generate_raw`` and ``generate_stream`` vs the
    JAX pipeline with the same seed, in f32 with 2 steps: the same tokens,
    chunks and buckets, chunk features within 5e-2 (mel units), equal wav
    lengths and wavs within WAV_ATOL."""
    from zipvoice_tpu.infer.pipeline import InferencePipeline as JaxPipeline

    jmodel, params, jtok, jvocos, jvocos_params = jax_side
    model, tok = load_model_dir(str(model_dir), device="cpu")
    vocos = load_vocos(str(model_dir / "pytorch_model.bin"), device="cpu")
    jpipe = fast_pipeline(JaxPipeline(jmodel, params, jvocos, jvocos_params,
                                      jtok, seed=5))
    tpipe = InferencePipeline(model, vocos, seed=5, device="cpu",
                              tokenizer=tok)
    jfeats, tfeats = [], []
    _recording(jpipe, jfeats)
    _recording(tpipe, tfeats)
    prompt = str(model_dir / "prompt.wav")
    kw = dict(num_step=2, guidance_scale=1.0, t_shift=0.5)

    # max_duration holds one chunk a micro-batch, as the stream runs them
    jw, jm = jpipe.generate_sentence(PROMPT_TEXT, prompt, TEXT,
                                     max_duration=4.0, **kw)
    tw, tm = tpipe.generate_sentence(PROMPT_TEXT, prompt, TEXT,
                                     max_duration=4.0, **kw)
    assert len(tm["chunk_tokens"]) == 2, tm["chunk_tokens"]
    assert tm["frames"] == sum(f.shape[0] for f in jfeats)
    jr, _ = jpipe.generate_raw(PROMPT_TEXT, prompt, FIRST, **kw)
    tr, _ = tpipe.generate_raw(PROMPT_TEXT, prompt, FIRST, **kw)

    p_tok = tok.texts_to_token_ids([PROMPT_TEXT])[0]
    wav = speech_like_wav(7, seconds=2.0)
    p_feat = tpipe.feature_extractor.extract(wav, 24000) * 0.1
    js = list(jpipe.generate_stream(p_tok, p_feat, TEXT, **kw))
    ts = list(tpipe.generate_stream(p_tok, p_feat, TEXT, **kw))

    assert tpipe._seen_buckets == jpipe._seen_buckets == {(1, 64, 384)}
    assert len(tfeats) == len(jfeats) == 5
    for t, j in zip(tfeats, jfeats):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, atol=5e-2, rtol=0)
    for t, j in [(tw, jw), (tr, jr)] + list(zip(ts, js)):
        assert t.shape == j.shape
        assert np.isfinite(t).all() and np.abs(t).max() <= 1.0
        np.testing.assert_allclose(t, j, atol=WAV_ATOL, rtol=0)
    assert len(ts) == len(js) == 3  # two chunks and the last fade's tail
    assert tm["t_frontend"] > 0 and tm["rtf"] > 0


def _read_wav(path):
    import wave

    with wave.open(path, "rb") as f:
        return f.getframerate(), f.getnchannels(), f.getnframes()


@pytest.fixture(scope="module", autouse=True)
def cli_runs(model_dir, tmp_path_factory):
    """Three CLI runs as subprocesses, started together with the module's
    first test so that they overlap the in-process comparisons: with
    ``--platform cpu`` one job from ``--text`` and a test list with an
    English line and a Chinese line with a <pinyin> tag; and one without
    ``--platform``, which needs CUDA."""
    out = tmp_path_factory.mktemp("cli")
    prompt = str(model_dir / "prompt.wav")
    common = ["--model-dir", str(model_dir), "--vocoder-path",
              str(model_dir / "pytorch_model.bin"), "--num-step", "2"]
    one = ["--prompt-wav", prompt, "--prompt-text", PROMPT_TEXT, "--text",
           "We walked home.", "--res-wav-path"]
    (out / "list.tsv").write_text(
        f"en\t{PROMPT_TEXT}\t{prompt}\tWe walked home.\n"
        f"zh\t{PROMPT_TEXT}\t{prompt}\t你好，<zhong1>国的朋友。\n",
        encoding="utf-8",
    )
    jobs = {
        "text": common + ["--platform", "cpu"] + one + [str(out / "one.wav")],
        "list": common + ["--platform", "cpu", "--test-list",
                          str(out / "list.tsv"), "--res-dir",
                          str(out / "res"), "--raw-evaluation"],
        "cuda": common + one + [str(out / "none.wav")],
    }
    # one thread each: the tiny model needs no more, and the runs leave
    # the cores to the comparisons beside them
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "zipvoice_torch.bin.infer_zipvoice", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, args in jobs.items()}

    def result(name):
        _, err = procs[name].communicate(timeout=120)
        return procs[name].returncode, err

    yield out, result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate(timeout=60)


def test_cli_runs_on_the_cpu(cli_runs):
    """With ``--platform cpu`` the CLI exits 0, writes 24 kHz mono wavs
    and logs each job's rtf."""
    out, result = cli_runs
    rc, err = result("text")
    assert rc == 0, err
    assert "rtf" in err
    sr, ch, n = _read_wav(str(out / "one.wav"))
    assert (sr, ch) == (24000, 1) and n > 0

    rc, err = result("list")
    assert rc == 0, err
    assert err.count("rtf") >= 3  # one line a job and the total
    for name in ("en", "zh"):
        sr, ch, n = _read_wav(str(out / "res" / f"{name}.wav"))
        assert (sr, ch) == (24000, 1) and n > 0


def test_cli_without_cuda_needs_platform_cpu(cli_runs):
    """The CLI runs on ``cuda`` by default: with no CUDA device it exits
    non-zero with ``resolve_device``'s message, and writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out, result = cli_runs
    rc, err = result("cuda")
    assert rc != 0
    assert "CUDA is not available; pass device='cpu'" in err
    assert not (out / "none.wav").exists()
