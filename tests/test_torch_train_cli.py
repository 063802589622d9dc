"""Port parity: the training entry points (``zipvoice_torch.bin``:
prepare_dataset, compute_fbank, train_zipvoice and generate_averaged_model;
``utils/structural_loaders.py``, ``train/averaging.py`` and the checkpoint
pair of ``utils/checkpoint_io.py``) against the JAX package, on the CPU.

The CLIs run in process at tests/test_train_cli.py's TINY_CFG widths, f32,
on a corpus of eight 1.3 s tones.  The structural loaders and the averaging
functions are held to the JAX package's within 1e-7 on the same weights;
a resumed run is held to an uninterrupted one bit for bit."""

import json
import string

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import torch

from test_train_cli import TINY_CFG
from zipvoice_torch.bin import (
    compute_fbank,
    generate_averaged_model,
    prepare_dataset,
    train_zipvoice,
)
from zipvoice_torch.frontend.audio import save_wav
from zipvoice_torch.train import averaging
from zipvoice_torch.utils import checkpoint_io, structural_loaders

DS = {"fm_decoder": tuple(TINY_CFG["fm_decoder_downsampling_factor"]),
      "text_encoder": (1,)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """prepare_dataset and compute_fbank on eight 1.3 s tones (one frame
    bucket, so every step has one shape): (dir, manifest, token file,
    model.json)."""
    d = tmp_path_factory.mktemp("train_cli")
    sr = 24000
    rows = []
    for i in range(8):
        n = int(1.3 * sr)
        wav = (0.2 * np.sin(2 * np.pi * (200 + 30 * i) * np.arange(n) / sr)
               ).astype(np.float32)[None]
        path = d / f"u{i}.wav"
        save_wav(str(path), wav, sr)
        rows.append(f"u{i}\thello world number {i}.\t{path}")
    (d / "train.tsv").write_text("\n".join(rows) + "\n")
    chars = ["_"] + list(string.ascii_lowercase) + list(" .,!?0123456789")
    tokens = d / "tokens.txt"
    tokens.write_text("".join(f"{c}\t{i}\n" for i, c in enumerate(chars)))
    manifest = prepare_dataset.main([
        "--tsv-path", str(d / "train.tsv"), "--prefix", "toy", "--subset",
        "train", "--output-dir", str(d / "manifests")])
    assert compute_fbank.main(["--manifest", manifest, "--output-dir",
                               str(d / "fbank")]) == 8
    (d / "model.json").write_text(json.dumps({"model": TINY_CFG}))
    return d, manifest, str(tokens), str(d / "model.json")


def _train(corpus, exp, *extra):
    _, manifest, tokens, cfg = corpus
    return train_zipvoice.main([
        "--train-manifest", manifest, "--token-file", tokens,
        "--tokenizer", "simple", "--model-config", cfg, "--exp-dir",
        str(exp), "--max-duration", "4", "--num-buckets", "1",
        "--base-lr", "0.01", "--log-interval", "1", "--save-every-n", "0",
        "--average-period", "1", "--no-bf16", "--platform", "cpu", *extra])


def test_data_prep_and_training(corpus):
    """The counterpart of tests/test_train_cli.py: prepare, fbank and one
    epoch in process write epoch-1, epoch-1-avg, tokens.txt and model.json,
    and log the loss in the exp dir's log; the manifest points at .fz
    features."""
    from zipvoice_torch.data.manifest import read_manifest

    d = corpus[0]
    cuts = read_manifest(corpus[1])
    assert len(cuts) == 8 and all(c.features.endswith(".fz") for c in cuts)
    history = _train(corpus, d / "exp", "--num-epochs", "1")
    assert len(history) == 2 and all(np.isfinite(h["loss"]) for h in history)
    exp = d / "exp"
    assert "loss" in (exp / "log" / "log-train-0").read_text()
    for name in ("epoch-1", "epoch-1-avg", "tokens.txt", "model.json",
                 "env.json"):
        assert (exp / name).exists(), name
    sd, train_state, extra = checkpoint_io.load_checkpoint(
        str(exp / "epoch-1"))
    assert train_state["step"] == 2 and extra["batch_idx_train"] == 2
    assert extra["sampler"]["epoch"] == 1
    assert json.loads((exp / "model.json").read_text())["model"] == TINY_CFG


def test_resume_is_bit_equal_to_an_uninterrupted_run(corpus):
    """Two epochs straight against one epoch plus ``--start-epoch 2``: the
    same steps on the same batches, and the parameters, the running
    average and the ScaledAdam state equal bit for bit.  Then
    ``generate_averaged_model --epoch 2 --avg 2`` writes a .pt that
    ``load_model_dir`` reads."""
    from zipvoice_torch.utils.checkpoint_io import load_model_dir

    d = corpus[0]
    straight = _train(corpus, d / "straight", "--num-epochs", "2")
    first = _train(corpus, d / "resumed", "--num-epochs", "1")
    second = _train(corpus, d / "resumed", "--num-epochs", "2",
                    "--start-epoch", "2")
    assert [(h["step"], h["ids"], h["loss"]) for h in first + second] == \
        [(h["step"], h["ids"], h["loss"]) for h in straight]
    for name in ("epoch-2", "epoch-2-avg"):
        want, want_ts, _ = checkpoint_io.load_checkpoint(
            str(d / "straight" / name))
        got, got_ts, _ = checkpoint_io.load_checkpoint(
            str(d / "resumed" / name))
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    for a, b in zip(jax.tree.leaves(want_ts), jax.tree.leaves(got_ts)):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
    out = generate_averaged_model.main([
        "--exp-dir", str(d / "resumed"), "--epoch", "2", "--avg", "2"])
    assert out == str(d / "resumed" / "model.pt")
    model, _ = load_model_dir(str(d / "resumed"), device="cpu")
    avg = checkpoint_io.load_checkpoint(str(d / "resumed" / "epoch-2-avg"))[0]
    for k, v in model.state_dict().items():
        # the whole run's average is epoch 2's running average itself
        assert torch.equal(v, avg[k].float()), k


def test_average_before_the_first_period_is_refused(corpus):
    """Two steps at the default --average-period of 200 never update the
    running average: ``generate_averaged_model`` says so instead of
    writing the initial weights."""
    exp = corpus[0] / "period"
    _train(corpus, exp, "--num-epochs", "1", "--average-period", "200")
    with pytest.raises(ValueError, match="fewer than its --average-period"):
        generate_averaged_model.main(["--exp-dir", str(exp), "--epoch", "1",
                                      "--avg", "1"])
    assert not (exp / "model.pt").exists()


@pytest.mark.parametrize("name", ["zipvoice", "zipvoice_distill",
                                  "zipvoice_dialog", "zipvoice_dialog_stereo"])
def test_build_model_loads_jax_params_strict(tmp_path, name):
    """``build_model`` builds the layout the JAX package's
    ``invert_zipvoice`` writes for each model name: a JAX param tree (the
    JAX converter's, from weights of another seed) inverted to the
    reference layout loads with ``strict=True``, tensor for tensor."""
    from zipvoice_tpu.utils.convert import convert_zipvoice, invert_zipvoice

    from zipvoice_torch.frontend.tokenizer import DialogTokenizer

    tokens = tmp_path / "tokens.txt"
    tokens.write_text("".join(f"{c}\t{i}\n" for i, c in enumerate(
        ["_"] + list("abcdefgh .") + ["[S1]", "[S2]"])))
    args = train_zipvoice.get_parser().parse_args([
        "--train-manifest", "m", "--token-file", str(tokens), "--exp-dir",
        "e", "--model-name", name, "--seed", "3"])
    (tmp_path / "model.json").write_text(json.dumps(TINY_CFG))
    args.model_config = str(tmp_path / "model.json")
    tok = DialogTokenizer(str(tokens))
    source, _ = train_zipvoice.build_model(args, tok, torch.float32, "cpu")
    args.seed = 4
    model, cfg = train_zipvoice.build_model(args, tok, torch.float32, "cpu")
    assert cfg == TINY_CFG
    params = convert_zipvoice({k: v.numpy()
                               for k, v in source.state_dict().items()})
    sd = {k: torch.from_numpy(np.asarray(v))
          for k, v in invert_zipvoice(params, DS).items()}
    model.load_state_dict(sd, strict=True)
    for k, v in source.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    if name == "zipvoice_dialog_stereo":
        assert {"fm_decoder.in_proj.0.weight",
                "fm_decoder.in_proj.1.weight"} <= set(sd)


def _flax(sd):
    from zipvoice_tpu.utils.convert import convert_zipvoice

    return convert_zipvoice({k: v.numpy() for k, v in sd.items()})


def _back(params):
    from zipvoice_tpu.utils.convert import invert_zipvoice

    return {k: torch.from_numpy(np.asarray(v, np.float32))
            for k, v in invert_zipvoice(params, DS).items()}


def _assert_close(got, want, tol=1e-7):
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0,
                                   atol=tol, err_msg=k)


def test_structural_loaders_match_jax():
    """``extend_vocab`` (base -> dialog, the same seeded draws),
    ``copy_proj_three_channel`` (dialog -> stereo) and ``graft_missing``
    on reference-layout state_dicts against the JAX package's on the
    converted params, within 1e-7."""
    from zipvoice_tpu.utils import structural_loaders as jsl

    from zipvoice_torch.models.dialog import ZipVoiceDialog
    from zipvoice_torch.models.zipvoice import build_zipvoice

    F = TINY_CFG["feat_dim"]
    base = build_zipvoice(device="cpu", seed=5, vocab_size=20,
                          **TINY_CFG).state_dict()
    got = structural_loaders.extend_vocab(
        base, 22, rng=np.random.RandomState(7), feat_dim=F)
    want = jsl.extend_vocab(_flax(base), 22, rng=np.random.RandomState(7),
                            feat_dim=F)
    _assert_close(got, _back(want))
    assert got["embed.weight"].shape == (22, TINY_CFG["text_embed_dim"])
    dialog = build_zipvoice(model_class=ZipVoiceDialog, device="cpu",
                            seed=6, vocab_size=22, spk_a_id=20, spk_b_id=21,
                            **TINY_CFG).state_dict()
    got = structural_loaders.copy_proj_three_channel(dialog, feat_dim=F)
    want = jsl.copy_proj_three_channel(_flax(dialog), feat_dim=F)
    _assert_close(got, _back(want))
    assert got["fm_decoder.in_proj.0.weight"].shape[1] == 5 * F
    # graft_missing adds what is absent, recursively, and keeps the rest
    dst = {"a": {"x": 1}, "b": 2}
    src = {"a": {"x": 9, "y": 3}, "c": 4}
    assert structural_loaders.graft_missing(dict(dst, a=dict(dst["a"])),
                                            src) == \
        jsl.graft_missing(dict(dst, a=dict(dst["a"])), src) == \
        {"a": {"x": 1, "y": 3}, "b": 2, "c": 4}


def test_averaging_matches_jax():
    """The running f64 average over five updates and the range average of
    two of its snapshots against the JAX package's functions on the same
    arrays: equal within 1e-7 (the same f64 arithmetic)."""
    from zipvoice_tpu.train import averaging as ja

    rng = np.random.RandomState(8)
    steps = [{k: rng.randn(*s).astype(np.float32)
              for k, s in (("w", (5, 7)), ("b", (7,)))} for _ in range(6)]
    mine = averaging.init_model_avg({k: torch.from_numpy(v)
                                     for k, v in steps[0].items()})
    theirs = ja.init_model_avg(steps[0])
    snaps = []
    for i, p in enumerate(steps[1:], start=1):
        mine = averaging.update_averaged_model(
            mine, {k: torch.from_numpy(v) for k, v in p.items()}, i * 2, 2)
        theirs = ja.update_averaged_model(theirs, p, i * 2, 2)
        snaps.append((dict(mine), dict(theirs), i * 2))
        for k in p:
            assert mine[k].dtype == torch.float64
            np.testing.assert_allclose(mine[k].numpy(), theirs[k], rtol=0,
                                       atol=1e-7)
    (m0, t0, b0), (m1, t1, b1) = snaps[1], snaps[4]
    got = averaging.average_checkpoints_with_averaged_model(m0, m1, b0, b1, 2)
    want = ja.average_checkpoints_with_averaged_model(t0, t1, b0, b1, 2)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-7)


def test_stereo_from_scratch_and_alternating_steps():
    """The counterpart of tests/test_stereo_init.py: the port's two-stream
    model builds both projection pairs (the JAX trainer grafts the second
    in), with the trunk shared; four steps alternate the stereo objective
    (se_weight 1, 2F features) and the mixed one (se_weight 0, F features)
    through one train step, and the losses are finite."""
    from test_stereo_init import TINY as STEREO_TINY

    from zipvoice_torch.models.dialog import ZipVoiceDialogStereo
    from zipvoice_torch.models.zipvoice import build_zipvoice
    from zipvoice_torch.train.optim import ScaledAdam
    from zipvoice_torch.train.train_step import make_train_step

    model = build_zipvoice(model_class=ZipVoiceDialogStereo, device="cpu",
                           train=True, **STEREO_TINY)
    names = dict(model.named_parameters())
    for name in ("in_proj.0", "in_proj.1", "out_proj.0", "out_proj.1"):
        assert f"fm_decoder.{name}.weight" in names, name
    assert names["fm_decoder.in_proj.0.weight"].shape != \
        names["fm_decoder.in_proj.1.weight"].shape
    F = STEREO_TINY["feat_dim"]
    B, T = 2, 24
    rng = np.random.RandomState(0)
    tokens = torch.tensor([[30, 3, 5, 31, 7, 2], [30, 4, 6, 8, 31, 2]])
    feats = torch.from_numpy(rng.randn(B, T, 2 * F).astype(np.float32))
    lens = torch.full((B,), T)
    opt = ScaledAdam(model.parameters(), lr=0.01)
    step = make_train_step(model, opt, condition_drop_ratio=0.0,
                           dropout_rate=0.0, seed=2)
    losses = []
    for i in range(4):
        f, se = (feats, 1.0) if i % 2 == 0 else (feats[:, :, :F], 0.0)
        m = step({"tokens": tokens, "tokens_lens": torch.tensor([6, 6]),
                  "features": f, "features_lens": lens}, se_weight=se)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and step.step == 4, losses


@pytest.mark.parametrize("flag", [
    ["--coordinator-address", "localhost:1"], ["--num-processes", "2"],
    ["--process-id", "1"], ["--num-data-parallel", "2"],
    ["--per-host-data", "on"], ["--inf-check"], ["--print-diagnostics"],
    [],
])
def test_waiting_flags_raise_and_cuda_is_the_default(corpus, flag):
    """Each flag whose part waits raises ``NotImplementedError`` naming its
    ROADMAP item before any work; with none of them, the trainer wants
    CUDA by default and fails without it."""
    _, manifest, tokens, cfg = corpus
    argv = ["--train-manifest", manifest, "--token-file", tokens,
            "--tokenizer", "simple", "--model-config", cfg, "--exp-dir",
            str(corpus[0] / "never"), *flag]
    if flag:
        with pytest.raises(NotImplementedError, match="ROADMAP A[56]"):
            train_zipvoice.main(argv + ["--platform", "cpu"])
    elif not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_zipvoice.main(argv)
    assert not (corpus[0] / "never" / "model.json").exists()
