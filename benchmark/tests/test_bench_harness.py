"""The benchmark's harness on the CPU, with no card: the traffic, the
metric arithmetic, the frozen counts, the reference against the port, the
toy cells added by files alone, the planted faults and the control, and the
modules a run loads.  ``python -m pytest benchmark/tests``."""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark import traffic_gen as tg
from benchmark.counts import flops, traffic
from benchmark.reference import model as ref
from benchmark.tests import toy

REPO = toy.REPO
SEED = 2147483659  # past 2**31: a seed need not fit 32 signed bits


def load_metric(name):
    return harness.load_file(os.path.join(REPO, "benchmark", "metrics",
                                          name + ".py"))


# --- traffic ---------------------------------------------------------------

def test_traffic_same_seed_same_inputs_other_seed_other_draws():
    corpus = tg.Corpus()
    spec = json.load(open(os.path.join(REPO, "benchmark", "traffic",
                                       "longform.json")))
    # the prompts and the pool are fixed data: every seed does the same work
    a = tg.prompts(corpus, spec["prompts"])
    b = tg.prompts(corpus, spec["prompts"])
    for x, y in zip(a, b):
        assert np.array_equal(x["wav"], y["wav"])
    pool = tg.passages(corpus, spec["passages"])
    assert [p["sentences"] for p in pool] == [n for _, n in
                                             spec["passages"]["spans"]]
    assert (tg.offline_call(3, pool, SEED)[2]
            == tg.offline_call(3, pool, SEED)[2]
            != tg.offline_call(3, pool, SEED + 1)[2])
    from benchmark.drivers.program import build_weights

    cfg = dict(json.load(open(os.path.join(
        REPO, "benchmark", "configs", "zipvoice.json"))),
        model=toy.TOY_MODEL, vocoder=toy.TOY_VOCOS)
    w1, _ = build_weights(cfg, SEED, torch.device("cpu"))
    w2, _ = build_weights(cfg, SEED, torch.device("cpu"))
    w3, _ = build_weights(cfg, SEED + 1, torch.device("cpu"))
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["embed.weight"], w3["embed.weight"])


def test_passage_tokens_are_the_frozen_sentence_tokens():
    """The program's tokenizer gives a passage the frozen phones of its
    sentences one after another (what the reference and the noise keys
    assume)."""
    from zipvoice_torch.frontend.text_chunking import add_punctuation
    from zipvoice_torch.frontend.tokenizer import EmiliaTokenizer

    corpus = tg.Corpus()
    tok = EmiliaTokenizer(corpus.tokens_path)
    for start, count in ((0, 3), (200, 12), (57, 2)):
        text, phones = corpus.span(start, count)
        assert tok.texts_to_tokens([add_punctuation(text)])[0] == phones
        assert tok.texts_to_tokens([text])[0] == phones


# --- metric arithmetic on a recorded toy window ----------------------------

TOY_REC = {
    "setup_s": 12.5, "window_s": 4.0, "audio_s": 200.0,
    "plain_window_s": 2.0, "flops": 0.5 * 989e12,
    "sample_calls": [{"B_real": 3, "B": 4, "T": 100, "fl": [90, 80, 70]},
                     {"B_real": 1, "B": 1, "T": 200, "fl": [150]}],
    "offline_calls": [{"t_frontend": 0.01, "t": 1.0, "t_vocoder": 0.05},
                      {"t_frontend": 0.03, "t": 3.0, "t_vocoder": 0.15}],
    "attn": {"h": 4, "qd": 32, "pd": 4},
    "trace": {"window_s": 2.0, "busy_s": 1.5, "kernels": [
        ["void rel_pos_mma_kernel<32, false>(...)", 0.5e-3, [20, 16, 1]],
        ["void rel_pos_mma_kernel<32, false>(...)", 0.5e-3, [20, 16, 1]],
        ["some_gemm", 9.0, [1, 1, 1]]]},
}


def test_metric_arithmetic():
    r = TOY_REC
    assert load_metric("audio_s_per_s").read(r) == 50.0
    assert load_metric("setup_s").read(r) == 12.5
    assert load_metric("pad_share").read(r) == pytest.approx(
        100 * (600 - 390) / 600)
    assert load_metric("mfu").read(r) == pytest.approx(25.0)
    assert load_metric("frontend_ms.offline").read(r) == pytest.approx(20.0)
    assert load_metric("vocoder_share.offline").read(r) == pytest.approx(5.0)
    assert load_metric("idle_share").read(r) == pytest.approx(25.0)
    # two launches at B=4, h=4, T=1280: the bound over their 1 ms
    want = 2 * traffic.bound(*traffic.attention_traffic(4, 4, 1280, 32, 4))[0]
    assert load_metric("attn_weights_roofline").read(r) == pytest.approx(
        100 * want * 1e-3 / 1e-3)
    # readers that find nothing return nothing
    for name in ("audio_s_per_s", "pad_share", "mfu", "idle_share",
                 "attn_weights_roofline", "frontend_ms.offline",
                 "vocoder_share.offline", "setup_s"):
        assert load_metric(name).read({}) is None


# --- the frozen counts -----------------------------------------------------

def test_counts_match_hand_numbers():
    # #1 at B=16, h=4, T=1280, qd=32, pd=4 (the kernel table's shape)
    b, f = traffic.attention_traffic(16, 4, 1280, 32, 4)
    assert b == 2 * (2 * 16 * 4 * 1280 * 32 + 16 * 4 * 1280 * 4
                     + 4 * 2559 * 4) + 16 * 1280 + 2 * 16 * 4 * 1280 ** 2
    assert round(b / 1e6, 1) == 221.0
    assert f == 16 * 4 * 1280 * 1280 * 72
    ms, by = traffic.bound(b, f)
    assert by == "bytes" and ms == pytest.approx(b / 3.35e12 * 1e3)
    bb, bf = traffic.bwd_traffic(8, 4, 1280, 32, 4, 2, penalty=False)
    assert round(bb / 1e6, 1) == 226.7 and bf == 8 * 4 * 1280 ** 2 * 150
    # one layer at T=10, d=8, ff=16, h=2, qd=4, pd=2, vd=3, pos_dim=4, k=3
    per_frame = 2 * (8 * 10 * 2 + 2 * 8 * 12 + 8 * 18 + 6 * 8 + 2 * 2 * 8 * 6
                     + 2 * 3 * 64 + 2 * 8 * 16 + 2 * 8 * 20) + 2 * 2 * 8 * 3
    pairs = 2 * 6 + 2 * 2 * 3 + 6
    want = 10 * per_frame + 2 * 100 * pairs + 2 * 19 * 4 * 2 * 2
    assert flops.layer_flops(10, 8, 16, 2, 4, 2, 3, 4, 3) == want
    # Vocos over 10 frames: embed, 8 blocks, head
    voc = dict(n_mels=100, dim=512, intermediate_dim=1536, num_layers=8,
               n_fft=1024)
    assert flops.vocos_flops(voc, 10) == 2 * 10 * (
        100 * 512 * 7 + 8 * (512 * 7 + 2 * 512 * 1536) + 512 * 1026)


def test_fm_decoder_count_matches_its_parameters():
    """Away from attention the fm_decoder's count is 2 operations a weight
    a frame at each level: its matrices' parameters, each stack's weighted
    by 1 / its downsampling."""
    cfg = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                      "zipvoice.json")))["model"]
    shapes = ref.zipvoice_shapes(cfg)
    T = 3840  # divisible by every factor
    lin = 0.0
    for name, shape in shapes.items():
        if not name.startswith("fm_decoder.encoders") or len(shape) < 2:
            continue
        if "linear_pos" in name or "time_emb" in name:
            continue  # the positional table and a per-row embedding
        stack = int(name.split(".")[2])
        ds = cfg["fm_decoder_downsampling_factor"][stack]
        lin += 2 * math.prod(shape) * T / ds
    lin += 2 * T * (300 * 512 + 512 * 100)
    total = flops.fm_decoder_flops(cfg, T)
    attn = total - lin
    # what is left is attention: T^2 pairs at each level
    want = sum(n * (2 * (T // ds) ** 2 * (4 * 36 + 2 * 4 * 12 + 384)
                    + 2 * (2 * (T // ds) - 1) * 48 * 16)
               for ds, n in zip(cfg["fm_decoder_downsampling_factor"],
                                cfg["fm_decoder_num_layers"]))
    assert attn == pytest.approx(want)


# --- the reference against the port ---------------------------------------

def test_reference_parameters_match_the_port():
    from zipvoice_torch.models import zipvoice
    from zipvoice_torch.vocoder.vocos import Vocos

    cfg = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                      "zipvoice.json")))
    with torch.device("meta"):
        model = zipvoice.ZipVoice(**cfg["model"])
        vocos = Vocos(**cfg["vocoder"])
    got = ref.zipvoice_shapes(cfg["model"])
    assert got == {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ref.vocos_shapes(cfg["vocoder"]) == {
        k: tuple(v.shape) for k, v in vocos.state_dict().items()}


def test_reference_sample_matches_the_port_in_float32():
    from zipvoice_torch.models import zipvoice

    from benchmark.drivers.program import build_weights

    cfg = dict(json.load(open(os.path.join(
        REPO, "benchmark", "configs", "zipvoice.json"))),
        model=toy.TOY_MODEL, vocoder=toy.TOY_VOCOS, dtype="float32")
    P, _ = build_weights(cfg, SEED, torch.device("cpu"))
    model = zipvoice.ZipVoice(**cfg["model"]).eval()
    model.load_state_dict(P)
    g = torch.Generator().manual_seed(0)
    B, S, T = 2, 40, 300
    tokens = torch.randint(1, 300, (B, S), generator=g)
    tl = torch.tensor([30, 38])
    pl = torch.tensor([60, 80])
    fl = torch.tensor([250, 280])
    pf = torch.randn(B, T, 100, generator=g)
    noise = torch.randn(B, T, 100, generator=g)
    kw = dict(num_step=3, guidance_scale=1.0, t_shift=0.5)
    with torch.no_grad():
        want, _ = model.sample(tokens, tl, tl // 3, pf, pl, fl, noise, **kw)
        got = ref.sample(ref.Params(P), cfg["model"], tokens, tl, pf, pl, fl,
                         noise, kw["num_step"], kw["guidance_scale"],
                         kw["t_shift"])
    mask = torch.arange(T)[None, :] < fl[:, None]
    assert torch.allclose(got[mask], want[mask], atol=1e-4, rtol=1e-4)


# --- whole toy runs ---------------------------------------------------------

@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return toy.make(str(tmp_path_factory.mktemp("bench")))


def run_toy(root, workload, *extra, seconds="4", trace="0"):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmark", "tests",
                                      "run_toy.py"),
         root, workload, str(SEED), seconds, trace, *extra],
        capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1]), out.stderr


@pytest.mark.parametrize("workload", ["toy.longform", "toy.longform_multi"])
def test_toy_cells_added_by_new_files_alone(checkout, workload):
    line, err = run_toy(checkout, workload)
    assert line["correct"] is True, err[-2000:]
    assert set(line["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert line["metrics"]["audio_s_per_s"]["value"] > 0
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "compared"
    traced, _ = run_toy(checkout, workload, trace="1")
    assert traced["correct"] is True
    # the toy metric, added by a file and an entry, is read
    assert traced["metrics"]["toy_calls"]["value"] >= 1
    assert {"pad_share", "mfu"} <= set(traced["metrics"])


@pytest.mark.parametrize("workload, fault", [
    ("toy.longform", "state_unchanged"),
    ("toy.longform_multi", "half_batch"),
    ("toy.longform", "token_altered"),
    ("toy.longform", "answer_altered"),
])
def test_a_planted_fault_makes_correct_false(checkout, workload, fault):
    """Each fault the cell can have (one chip: no exchange between chips),
    planted under the timed path, at the cells' own limits."""
    line, err = run_toy(checkout, workload, "--fault", fault)
    assert line["correct"] is False, err[-2000:]
    assert "batches (rows, B, T) [(2, 2," in err or workload != \
        "toy.longform_multi"


@pytest.mark.parametrize("workload", ["toy.longform", "toy.longform_multi"])
def test_the_fp8_control_makes_correct_false(checkout, workload):
    line, _ = run_toy(checkout, workload, "--control", "fp8")
    assert line["correct"] is False


# --- what a run loads and how it ends ---------------------------------------

def test_no_module_of_the_run_is_jax():
    """Every module a run imports (the harness, the drivers,
    the readers, the reference and the port's modules they reach) leaves no
    forbidden top-level name in ``sys.modules``."""
    code = (
        "import sys, os; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "import benchmark.run, benchmark.drivers.offline\n"
        "import benchmark.reference.check, benchmark.tests.faults\n"
        "from benchmark.drivers.program import build_pipeline\n"
        "import zipvoice_torch.infer.pipeline\n"
        "import zipvoice_torch.frontend.tokenizer\n"
        "import zipvoice_torch.vocoder.vocos\n"
        "for f in os.listdir(os.path.join(%r, 'benchmark', 'metrics')):\n"
        "    harness.load_file(os.path.join(%r, 'benchmark', 'metrics', f))\n"
        "print(harness.forbidden_loaded())\n") % (REPO, REPO, REPO)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_exits_without_a_card_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmark", "run.py"),
         "--workload", "zipvoice.longform", "--seed", str(SEED),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_fails_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder: no
    result, a non-zero exit (here past the card's check, which the CPU
    would fail first)."""
    import shutil

    root = tmp_path / "bare"
    shutil.copytree(os.path.join(REPO, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import harness\n"
            "run = harness.load_file(%r)\n"
            "sys.exit(run.main(['--workload', 'zipvoice.longform', '--seed',"
            " '1', '--seconds', '1', '--trace', '0'], allow_cpu=True))\n"
            ) % (str(root), str(root / "benchmark" / "run.py"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(root), env=env)
    assert out.returncode != 0
    assert "zipvoice_torch" in out.stderr
    assert not out.stdout.strip().startswith("{")
