"""The port's evaluation (``zipvoice_torch/eval/``) against the JAX
package's ``zipvoice_tpu/eval/``, on the CPU.

- the metrics: every string and array of tests/test_eval_metrics.py (the
  strings of the case that needs the reference repo included, through both
  packages' ``post_process``) and of tests/test_cpsim.py give equal results
  through both packages (the structural loaders of that file are held by
  tests/test_torch_train_cli.py);
- ``UTMOS22Strong`` and ``EcapaWavLM`` have the JAX package's
  ``state_dict`` keys and, on one random ``state_dict``, outputs within
  1e-6 of its modules' (``EcapaWavLM`` over the miniature WavLM of
  tests/test_eval_drivers.py, from the waveform), and
  ``load_head_checkpoint`` loads the same head;
- ``sim_cli``, ``utmos_cli``, ``wer_cli`` (the pipeline backend) and
  ``cpsim_cli`` with ``--platform cpu`` write the JAX drivers' reports on
  the miniature models of tests/test_eval_drivers.py and
  tests/test_wer_backends.py; ``transcribe_whisper`` decodes as JAX's
  does through both of its branches; ``_auto_backend`` picks the same
  backends.

Each miniature model is built once, by the fixture of the cases that read
it; the drivers read one shared set of wavs.  Where no module of the
process has imported transformers yet, the ``hf`` fixture imports it
without its TensorFlow backend (``USE_TF=0`` for that import only; no test
uses TensorFlow, whose import took 7-14 s); where the JAX package's
transformers tests were collected, they imported it already and nothing
changes.
"""

import importlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import conftest  # noqa: F401

import torch

from torch_parity import one_torch_thread  # noqa: F401
from zipvoice_torch.eval import metrics
from zipvoice_torch.frontend.audio import save_wav
from zipvoice_tpu.eval import metrics as jax_metrics

SR = 16000

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# tests/test_eval_metrics.py's calls (post_process: the reference case's)
METRIC_CASES = [
    ("edit_distance", ("abc", "abc")),
    ("edit_distance", (list("kitten"), list("sitting"))),
    ("edit_distance", (["a", "b"], ["a", "x", "b"])),
    ("wer", ("Hello, world!", "hello world")),
    ("wer", ("the cat sat", "the cat sit down")),
    ("corpus_wer", ([("a b", "a b"), ("a b", "a x")],)),
    ("normalize_text", ("你好 世界", "zh")),
    ("split_speakers", ("[S1] hello there [S2] hi [S1] bye",)),
    ("cpwer", ("[S1] hello there [S2] good morning",
               "[S1] good morning [S2] hello there")),
    ("cpwer", ("[S1] hello there [S2] good morning",) * 2),
    ("cosine_similarity", (np.array([1.0, 0.0]), np.array([1.0, 0.0]))),
    ("cosine_similarity", (np.array([1.0, 0.0]), np.array([0.0, 1.0]))),
    ("post_process", ("Hello, World! It's co-op; fine?", "en")),
    ("post_process", ("The  quick... brown 'fox'!", "en")),
    ("post_process", ("你好，世界！“引用”……完。", "zh")),
    ("post_process", ("中文 with English mixed, ok?", "zh")),
    ("post_process", ("no punct here", "en")),
]


@pytest.mark.parametrize("name,args", METRIC_CASES,
                         ids=[f"{n}{i}" for i, (n, _) in
                              enumerate(METRIC_CASES)])
def test_metrics_match_jax(name, args):
    assert getattr(metrics, name)(*args) == getattr(jax_metrics, name)(*args)


def _tone(f0, seconds, seed=0, amp=0.1):
    rng = np.random.RandomState(seed)
    t = np.arange(int(SR * seconds)) / SR
    return (amp * np.sin(2 * np.pi * f0 * t)
            + 0.01 * amp * rng.randn(t.size)).astype(np.float32)


def _spectrum(x):
    spec = np.abs(np.fft.rfft(x * np.hanning(len(x)), n=4096))[:512]
    return spec / (np.linalg.norm(spec) + 1e-9)


def test_cpsim_matches_jax():
    """tests/test_cpsim.py's inputs: the VAD of a tone between silences,
    2-means of two clusters, the diarization of two alternating tones."""
    from zipvoice_tpu.eval import cpsim_cli as jax_cpsim
    from zipvoice_torch.eval import cpsim_cli

    sil = np.zeros(SR, np.float32)
    wav = np.concatenate([sil, _tone(300, 1.0, amp=0.3), sil])
    for got, want in zip(cpsim_cli.energy_vad(wav, SR),
                         jax_cpsim.energy_vad(wav, SR)):
        np.testing.assert_array_equal(got, want)
    rng = np.random.RandomState(0)
    X = np.concatenate([rng.randn(20, 8) + np.array([5.0] + [0] * 7),
                        rng.randn(20, 8) + np.array([-5.0] + [0] * 7)])
    np.testing.assert_array_equal(cpsim_cli.kmeans2(X),
                                  jax_cpsim.kmeans2(X))
    half = np.zeros(SR // 2, np.float32)
    wav = np.concatenate([_tone(200, 1.0, amp=3), half,
                          _tone(1200, 1.0, amp=3), half,
                          _tone(200, 1.0, amp=3), half,
                          _tone(1200, 1.0, amp=3)])
    for got, want in zip(cpsim_cli.diarize_two(wav, SR, _spectrum),
                         jax_cpsim.diarize_two(wav, SR, _spectrum)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def hf():
    """transformers' miniature-model builders of tests/test_eval_drivers.py
    and tests/test_wer_backends.py (transformers imported as the module's
    docstring says)."""
    with pytest.MonkeyPatch.context() as mp:
        if "transformers" not in sys.modules:
            mp.setenv("USE_TF", "0")
        pytest.importorskip("transformers")
        from test_eval_drivers import _make_tiny_wavlm_sv
        from test_wer_backends import _make_tiny_ctc, _make_tiny_whisper
    return SimpleNamespace(wavlm_sv=_make_tiny_wavlm_sv, ctc=_make_tiny_ctc,
                           whisper=_make_tiny_whisper)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """The wavs every driver reads and their lists: two generated wavs
    and their prompts (``test_list``), a dialog wav of two alternating
    voices (``dialog_list``) and the first wav alone (``utmos_list``)."""
    d = tmp_path_factory.mktemp("eval")
    paths = {"wavs": d / "wavs"}
    paths["wavs"].mkdir()
    rows = []
    for i, name in enumerate(["utt1", "utt2"]):
        save_wav(str(paths["wavs"] / f"{name}.wav"),
                 _tone(220 + 110 * i, 0.6, seed=i), SR)
        prompt = str(d / f"prompt{i}.wav")
        save_wav(prompt, _tone(220 + 110 * i, 0.6, seed=10 + i), SR)
        rows.append(f"{name}\tprompt text\t{prompt}\thello world")
    (d / "test.tsv").write_text("\n".join(rows) + "\n")
    half = np.zeros(SR // 2, np.float32)
    save_wav(str(paths["wavs"] / "dlg.wav"), np.concatenate(
        [_tone(200, 0.4), half, _tone(1200, 0.4), half, _tone(200, 0.4)]),
        SR)
    (d / "dialog.tsv").write_text(
        f"dlg\t[S1] hi [S2] hello\t{d / 'prompt0.wav'},{d / 'prompt1.wav'}"
        "\t[S1] hi [S2] hello\n")
    (d / "utmos.tsv").write_text(rows[0] + "\n")
    paths["test_list"] = str(d / "test.tsv")
    paths["utmos_list"] = str(d / "utmos.tsv")
    paths["dialog_list"] = str(d / "dialog.tsv")
    return paths


@pytest.fixture(scope="module")
def sv(hf, tmp_path_factory):
    """A miniature WavLM speaker-verification model dir."""
    d = str(tmp_path_factory.mktemp("sv"))
    hf.wavlm_sv(d)
    return d


@pytest.fixture(scope="module")
def ctc(hf, tmp_path_factory):
    """A miniature CTC model dir."""
    d = str(tmp_path_factory.mktemp("ctc"))
    hf.ctc(d)
    return d


@pytest.fixture(scope="module")
def whisper(hf, tmp_path_factory):
    """Two miniature Whisper dirs, with and without the language maps."""
    d = tmp_path_factory.mktemp("whisper")
    paths = {"whisper": str(d / "maps"), "whisper_forced": str(d / "forced")}
    hf.whisper(paths["whisper"], with_lang_maps=True)
    hf.whisper(paths["whisper_forced"], with_lang_maps=False)
    return paths


@pytest.fixture(scope="module")
def utmos(tmp_path_factory):
    """(checkpoint path, module): a random UTMOS22Strong of the JAX
    package's module (its zero embeddings drawn too, so that no constant
    hides a wiring fault)."""
    from zipvoice_tpu.eval.utmos_model import UTMOS22Strong

    path = str(tmp_path_factory.mktemp("utmos") / "utmos.pt")
    torch.manual_seed(0)
    module = UTMOS22Strong()
    with torch.no_grad():
        for p in (module.domain_emb, module.judge_emb,
                  module.wav2vec2.mask_emb):
            p.normal_()
    torch.save(module.state_dict(), path)
    return path, module.eval()


def test_utmos_model_matches_jax(utmos):
    from zipvoice_torch.eval.utmos_model import UTMOS22Strong

    path, want_module = utmos
    sd = torch.load(path)
    with torch.device("meta"):
        port = UTMOS22Strong()
    assert set(port.state_dict()) == set(sd)
    port.load_state_dict(sd, assign=True)
    port.eval()
    wav = torch.from_numpy(np.stack([_tone(220, 0.25),
                                     _tone(330, 0.25, 1)]))
    with torch.no_grad():
        got, want = port(wav, SR), want_module(wav, SR)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6,
                               rtol=0)


def test_ecapa_matches_jax(sv, tmp_path):
    """The head over the miniature WavLM, from the waveform (the
    softmax-weighted hidden states, the SE-Res2 blocks, the pooling, the
    embedding), on one random state_dict; then ``load_head_checkpoint`` of
    that head into a fresh module."""
    from zipvoice_tpu.eval.speaker_model import EcapaWavLM as JaxEcapa
    from zipvoice_torch.eval.speaker_model import EcapaWavLM

    torch.manual_seed(0)
    want_model = JaxEcapa(wavlm_path=sv, channels=64).eval()
    port = EcapaWavLM(wavlm_path=sv, channels=64).eval()
    sd = want_model.state_dict()
    assert set(port.state_dict()) == set(sd)
    g = torch.Generator().manual_seed(1)
    # the head's weights; the WavLM's are the file's
    sd = {k: (v + 0.05 * torch.randn(v.shape, generator=g)
              if v.is_floating_point() and not k.startswith("ssl.") else v)
          for k, v in sd.items()}
    sd = {k: (v.abs() + 0.5 if k.endswith("running_var") else v)
          for k, v in sd.items()}
    want_model.load_state_dict(sd)
    port.load_state_dict(sd)
    wav = torch.from_numpy(np.stack([_tone(220, 0.8), _tone(330, 0.8, 1)]))
    with torch.no_grad():
        want = want_model(wav)
        got = port(wav)
    assert got.shape == (2, 192) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)

    ckpt = str(tmp_path / "head.pth")
    torch.save({"model": {k: v for k, v in sd.items()
                          if not k.startswith("ssl.")}}, ckpt)
    fresh = EcapaWavLM(wavlm_path=sv, channels=64).eval()
    fresh.load_head_checkpoint(ckpt)
    with torch.no_grad():
        np.testing.assert_array_equal(fresh(wav).numpy(), got.numpy())


def _reports(monkeypatch, jax_main, port_main, argv, out_dir):
    """The JAX driver's and the port's ``--out`` reports for ``argv``."""
    outs = [str(out_dir / "jax.txt"), str(out_dir / "port.txt")]
    monkeypatch.setattr(sys, "argv", ["driver", *argv, "--out", outs[0]])
    jax_main()
    port_main([*argv, "--out", outs[1], "--platform", "cpu"])
    return [open(o).read() for o in outs]


@pytest.mark.parametrize("driver", ["sim", "utmos", "wer", "cpsim"])
def test_driver_reports_match_jax(wavs, request, monkeypatch, tmp_path,
                                  driver):
    jax_mod = importlib.import_module(f"zipvoice_tpu.eval.{driver}_cli")
    port_mod = importlib.import_module(f"zipvoice_torch.eval.{driver}_cli")
    wav_dir = str(wavs["wavs"])
    # the one model the driver reads
    model = request.getfixturevalue(
        {"utmos": "utmos", "wer": "ctc"}.get(driver, "sv"))
    argv = {
        "sim": ["--spk-model-path", model],
        "utmos": ["--utmos-model-path", model[0]],
        "wer": ["--lang", "en", "--asr-model-path", model,
                "--backend", "pipeline", "--dialog"],
        "cpsim": ["--spk-model-path", model],
    }[driver]
    # UTMOS's wav2vec2-base scores one wav; cpSIM one dialog
    test_list = wavs[{"utmos": "utmos_list", "cpsim": "dialog_list"}.get(
        driver, "test_list")]
    want, got = _reports(monkeypatch, jax_mod.main, port_mod.main,
                         ["--wav-dir", wav_dir, "--test-list", test_list,
                          *argv], tmp_path)
    assert got == want
    assert len(got.strip().split("\n")) == (
        2 if driver in ("utmos", "cpsim") else 3)


@pytest.mark.parametrize("model", ["whisper", "whisper_forced"])
def test_whisper_matches_jax(wavs, whisper, model):
    """Both branches of the forced language+transcribe prompt."""
    from zipvoice_tpu.eval.wer_cli import transcribe_whisper as jax_whisper
    from zipvoice_torch.eval.wer_cli import transcribe_whisper

    paths = [str(wavs["wavs"] / "utt1.wav")]
    got = transcribe_whisper(whisper[model], paths, "en", "cpu")
    assert got == jax_whisper(whisper[model], paths, "en")
    assert len(got) == 1 and isinstance(got[0], str)


def test_auto_backend_matches_jax():
    from zipvoice_tpu.eval.wer_cli import _auto_backend as jax_auto
    from zipvoice_torch.eval.wer_cli import _auto_backend

    for lang, path in (("en", "/m/whisper-large-v3"),
                       ("en", "/m/hubert-large-ls960-ft"),
                       ("zh", "/m/paraformer-zh"),
                       ("en", "/m/paraformer-zh")):
        assert _auto_backend(lang, path) == jax_auto(lang, path)


def test_drivers_want_cuda_unless_told_cpu(wavs, tmp_path):
    """Without CUDA a driver fails unless given ``--platform cpu``."""
    if torch.cuda.is_available():
        pytest.skip("this checks the machine without CUDA")
    from zipvoice_torch.eval import utmos_cli

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        # the device is refused before the model is read
        utmos_cli.main(["--wav-dir", str(wavs["wavs"]), "--test-list",
                        wavs["test_list"], "--utmos-model-path",
                        str(tmp_path / "absent.pt")])
