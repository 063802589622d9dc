"""Port parity: the dialog pipelines (``DialogInferencePipeline``,
``StereoDialogInferencePipeline``), ``load_model_dir`` for the dialog
models and the ``bin/infer_zipvoice_dialog`` CLI, against the JAX package
on tiny random model dirs written by the port's ``bin/make_model_dir.py``
at ``--tiny``'s widths (100 mel bins, a narrow Vocos).

Tolerances are those of test_torch_infer_cli.py: chunk features within
5e-2 (mel units) and wavs within its WAV_ATOL."""

import os
import subprocess
import sys

import numpy as np
import pytest

import conftest  # noqa: F401

import torch

from test_torch_infer_cli import WAV_ATOL, _read_wav, _recording
from torch_parity import DS, jax_jit
from zipvoice_torch.bin.make_model_dir import (
    TINY_CONFIG,
    TINY_VOCOS,
    make_model_dir,
)
from zipvoice_torch.frontend.audio import save_wav
from zipvoice_torch.infer.dialog_pipeline import (
    DialogInferencePipeline,
    StereoDialogInferencePipeline,
)
from zipvoice_torch.infer.workload import speech_like_wav
from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos
from zipvoice_torch.utils.convert import state_dict_from_jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("zipvoice_dialog", "zipvoice_dialog_stereo")
# ``--tiny``'s widths with one fm_decoder layer in place of five stacks:
# the JAX side's traces of the decoder's layers take most of this file's
# time, and the pipelines do not depend on the decoder's depth
CONFIG = dict(TINY_CONFIG, fm_decoder_downsampling_factor=[1],
              fm_decoder_num_layers=[1],
              fm_decoder_cnn_module_kernel=[7])
DS = dict(DS, fm_decoder=tuple(CONFIG["fm_decoder_downsampling_factor"]))
PROMPT_TEXTS = ["Hi, there.", "Hello, my friend."]
# Four turns, two chunks: a tag unknown to the vocabulary is one token
# toward the chunk budget (about 25 s at the prompt's token rate) but has
# no id, so the text splits at its second [S1] while the frame buckets stay
# small (see test_torch_infer_cli.py).  The two chunks land in one bucket.
TEXT = ("[S1]" + "[breath]" * 250 + " We walked. [S2] Yes. [S1]"
        + "[breath]" * 250 + " Birds sang. [S2] Good.")
STEREO_TEXT = "[S1] Hi. [S2] Yes."
MONO_KW = dict(num_step=2, guidance_scale=1.5, t_shift=0.5)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Both model dirs, two mono prompts of two speakers, the mono merge of
    the two (as ``merge_prompts`` makes it) and the two laid on opposite
    channels of one stereo wav."""
    out = tmp_path_factory.mktemp("dialog")
    for seed, name in enumerate(NAMES):
        make_model_dir(str(out / name), name, config=CONFIG,
                       seed=seed + 3, vocos_config=TINY_VOCOS)
    wavs = [speech_like_wav(s, seconds=1.0) for s in (1, 2)]
    for i, w in enumerate(wavs):
        save_wav(str(out / f"p{i + 1}.wav"), w, 24000)
    stereo = np.zeros((2, wavs[0].shape[1] + wavs[1].shape[1]), np.float32)
    stereo[0, : wavs[0].shape[1]] = wavs[0][0]
    stereo[1, wavs[0].shape[1]:] = wavs[1][0]
    save_wav(str(out / "stereo.wav"), stereo, 24000)
    return out


def _fast(jpipe):
    """Compile the JAX pipeline's sample and vocoder programs with XLA's
    backend optimizations off (``torch_parity.jax_jit``), as every parity
    test here does: they cost more compile time than these tiny programs
    run for."""
    sample_fn, vocode_fn, cache = jpipe._sample_fn, jpipe._vocode_fn, {}

    def fast_sample(*key):
        if key not in cache:
            cache[key] = jax_jit(sample_fn(*key))
        return cache[key]

    vocode = jax_jit(vocode_fn())
    jpipe._sample_fn = fast_sample
    jpipe._vocode_fn = lambda: vocode
    return jpipe


@pytest.fixture(scope="module")
def pipes(dirs):
    """For each model name: (JAX pipeline, port pipeline) on the same dir
    and seed, in f32 on the CPU, each recording its chunks' features; and
    the JAX params, to check the loads against."""
    from zipvoice_tpu.infer.dialog_pipeline import (
        DialogInferencePipeline as JaxDialog,
    )
    from zipvoice_tpu.infer.dialog_pipeline import (
        StereoDialogInferencePipeline as JaxStereo,
    )
    from zipvoice_tpu.utils.checkpoint_io import (
        load_model_dir as jax_load_model_dir,
    )
    from zipvoice_tpu.utils.checkpoint_io import load_vocos as jax_load_vocos
    from zipvoice_tpu.vocoder.vocos import Vocos as JaxVocos

    out = {}
    for name, jcls, tcls in zip(NAMES, (JaxDialog, JaxStereo),
                                (DialogInferencePipeline,
                                 StereoDialogInferencePipeline)):
        d = str(dirs / name)
        jmodel, params, jtok = jax_load_model_dir(d, name)
        _, vparams = jax_load_vocos(os.path.join(d, "pytorch_model.bin"))
        jpipe = _fast(jcls(jmodel, params, JaxVocos(**TINY_VOCOS), vparams,
                           jtok, seed=5))
        model, tok = load_model_dir(d, name, device="cpu")
        vocos = load_vocos(os.path.join(d, "pytorch_model.bin"),
                           device="cpu")
        tpipe = tcls(model, vocos, seed=5, device="cpu", tokenizer=tok)
        feats = ([], [])
        _recording(jpipe, feats[0])
        _recording(tpipe, feats[1])
        out[name] = (jpipe, tpipe, feats, params, jtok)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_load_model_dir_matches_jax(name, dirs, pipes):
    """Both packages read the same weights, tensor for tensor, the speaker
    embedding and the stereo model's projection pairs among them, and the
    same [S1]/[S2] ids; the bf16 load casts the decoder's matmuls."""
    _, tpipe, _, params, jtok = pipes[name]
    tok = tpipe.tokenizer
    assert (tok.spk_a_id, tok.spk_b_id, tok.vocab_size) == (
        jtok.spk_a_id, jtok.spk_b_id, jtok.vocab_size)
    model = tpipe.model
    assert (model.spk_a_id, model.spk_b_id) == (tok.spk_a_id, tok.spk_b_id)
    want = state_dict_from_jax_params(params["params"], DS)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert "spk_embed.weight" in got
    assert ("fm_decoder.in_proj.1.weight" in got) == name.endswith("stereo")

    bf16, _ = load_model_dir(str(dirs / name), name, dtype=torch.bfloat16,
                             device="cpu")
    proj = bf16.fm_decoder.in_proj
    for p in (proj if isinstance(proj, torch.nn.ModuleList) else [proj]):
        assert p.weight.dtype == torch.bfloat16
    assert bf16.spk_embed.weight.dtype == torch.float32


def _assert_same(jpipe, tpipe, feats, jwav, twav, jm, tm, channels):
    """The same buckets and chunk lengths, features within 5e-2, wavs of
    the same shape within WAV_ATOL, and the JAX package's metric keys."""
    assert tpipe._seen_buckets == jpipe._seen_buckets
    jf, tf = feats
    assert len(tf) == len(jf) > 0
    for t, j in zip(tf, jf):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, atol=5e-2, rtol=0)
    assert twav.shape == jwav.shape and twav.shape[0] == channels
    assert np.isfinite(twav).all() and np.abs(twav).max() <= 1.0
    np.testing.assert_allclose(twav, jwav, atol=WAV_ATOL, rtol=0)
    assert set(jm) <= set(tm)
    assert tm["wav_seconds"] == jm["wav_seconds"] and tm["rtf"] > 0
    jf.clear()
    tf.clear()


def test_mono_dialog_matches_jax(dirs, pipes):
    """``generate_dialog`` with the two speakers' prompts (merged by the
    pipeline) and with a merged prompt: the same tokens, two chunks at the
    same buckets, features and wavs as JAX's."""
    jpipe, tpipe, feats, _, _ = pipes["zipvoice_dialog"]
    split = ([*PROMPT_TEXTS], [str(dirs / "p1.wav"), str(dirs / "p2.wav")])
    jt, jw = jpipe.merge_prompts(*split)
    tt, tw = tpipe.merge_prompts(*split)
    assert tt == jt == f"[S1]{PROMPT_TEXTS[0]}[S2]{PROMPT_TEXTS[1]}"
    np.testing.assert_array_equal(tw, jw)
    assert (tpipe.tokenizer.texts_to_token_ids([TEXT])
            == jpipe.tokenizer.texts_to_token_ids([TEXT]))

    jwav, jm = jpipe.generate_dialog(*split, TEXT, **MONO_KW)
    twav, tm = tpipe.generate_dialog(*split, TEXT, **MONO_KW)
    assert len(tm["chunk_tokens"]) == 2, tm["chunk_tokens"]
    assert tm["t_frontend"] > 0
    _assert_same(jpipe, tpipe, feats, jwav, twav, jm, tm, channels=1)

    merged = str(dirs / "merged.wav")
    save_wav(merged, tw, 24000)
    jwav, jm = jpipe.generate_dialog(tt, merged, TEXT, **MONO_KW)
    twav, tm = tpipe.generate_dialog(tt, merged, TEXT, **MONO_KW)
    _assert_same(jpipe, tpipe, feats, jwav, twav, jm, tm, channels=1)


def test_stereo_dialog_matches_jax(dirs, pipes):
    """``generate_dialog_stereo`` with two mono prompts laid on opposite
    channels and with the same layout as one stereo prompt: (T, 2F)
    features and two-channel wavs as JAX's."""
    jpipe, tpipe, feats, _, _ = pipes["zipvoice_dialog_stereo"]
    split = ([*PROMPT_TEXTS], [str(dirs / "p1.wav"), str(dirs / "p2.wav")])
    np.testing.assert_array_equal(tpipe._load_stereo_prompt(split[1]),
                                  jpipe._load_stereo_prompt(split[1]))
    for prompt in (split, (f"[S1]{PROMPT_TEXTS[0]}[S2]{PROMPT_TEXTS[1]}",
                           str(dirs / "stereo.wav"))):
        jwav, jm = jpipe.generate_dialog_stereo(*prompt, STEREO_TEXT,
                                                **MONO_KW)
        twav, tm = tpipe.generate_dialog_stereo(*prompt, STEREO_TEXT,
                                                **MONO_KW)
        assert feats[1][0].shape[1] == 2 * CONFIG["feat_dim"]
        _assert_same(jpipe, tpipe, feats, jwav, twav, jm, tm, channels=2)
    assert len(tpipe._seen_buckets) == 1
    with pytest.raises(ValueError, match="must be stereo"):
        tpipe._load_stereo_prompt(str(dirs / "p1.wav"))


@pytest.fixture(scope="module", autouse=True)
def cli_runs(dirs, tmp_path_factory):
    """Three CLI runs as subprocesses, started with the module's first
    test so that they overlap the in-process comparisons: with
    ``--platform cpu`` a test list of a split-prompt line and a merged one
    for each model, and one run without ``--platform``, which needs
    CUDA."""
    out = tmp_path_factory.mktemp("cli")
    p1, p2 = str(dirs / "p1.wav"), str(dirs / "p2.wav")
    merged = "[S1]Hi, there.[S2]Hello, my friend."
    lines = {
        "zipvoice_dialog": (p1, str(dirs / "p2.wav")),
        "zipvoice_dialog_stereo": (p1, str(dirs / "stereo.wav")),
    }
    jobs = {}
    for name, (_, merged_wav) in lines.items():
        (out / f"{name}.tsv").write_text(
            f"split\t{PROMPT_TEXTS[0]}\t{PROMPT_TEXTS[1]}\t{p1}\t{p2}\t"
            f"{STEREO_TEXT}\n"
            f"merged\t{merged}\t{merged_wav}\t[S1] Good night.\n",
            encoding="utf-8",
        )
        jobs[name] = [
            "--model-name", name, "--model-dir", str(dirs / name),
            "--vocoder-path", str(dirs / name / "pytorch_model.bin"),
            "--num-step", "2", "--platform", "cpu", "--test-list",
            str(out / f"{name}.tsv"), "--res-dir", str(out / name),
        ]
    jobs["cuda"] = [
        "--model-dir", str(dirs / "zipvoice_dialog"), "--prompt-text-1",
        merged, "--prompt-wav-1", p1, "--merged-prompt", "--text",
        "[S1] Hi.", "--res-wav-path", str(out / "none.wav"),
    ]
    # one thread each: the tiny models need no more, and the runs leave
    # the cores to the comparisons beside them
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "zipvoice_torch.bin.infer_zipvoice_dialog",
         *args], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name, args in jobs.items()}

    def result(name):
        _, err = procs[name].communicate(timeout=120)
        return procs[name].returncode, err

    yield out, result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize("name", NAMES)
def test_cli_runs_on_the_cpu(name, cli_runs):
    """With ``--platform cpu`` the CLI exits 0 on a test list of both
    formats, writes a 24 kHz wav a line (one channel for the mono model,
    two for stereo) and logs each job's rtf."""
    out, result = cli_runs
    rc, err = result(name)
    assert rc == 0, err
    assert err.count("rtf") >= 3  # one line a job and the total
    channels = 2 if name.endswith("stereo") else 1
    for job in ("split", "merged"):
        sr, ch, n = _read_wav(str(out / name / f"{job}.wav"))
        assert (sr, ch) == (24000, channels) and n > 0


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
