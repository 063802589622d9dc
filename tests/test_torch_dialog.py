"""Port parity: ZipVoice-Dialog and ZipVoice-Dialog-Stereo
(``zipvoice_torch.models.dialog``) against the JAX package's
``zipvoice_tpu.models.dialog``, f32 on the CPU, on a tiny config (one
fm_decoder layer) whose
weights are perturbed from the port's init and carried into JAX through
``convert_zipvoice`` and back through ``state_dict_from_jax_params``.

Tolerances: the text embedding and the two-stream decoder within 2e-4, the
losses within 1e-4, two CFG sampling steps within 5e-3 (the backbone,
training-loss and chained-sampling bounds the port is held to)."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from torch_parity import (  # noqa: F401
    DS,
    TINY,
    jax_jit,
    one_torch_thread,
    to_jax,
    to_torch,
)
from zipvoice_torch.models.conditioning import condition_time_mask
from zipvoice_torch.models.dialog import ZipVoiceDialog, ZipVoiceDialogStereo
from zipvoice_torch.models.zipvoice import build_zipvoice
from zipvoice_torch.utils.convert import state_dict_from_jax_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SPK = dict(spk_a_id=28, spk_b_id=29)
# one fm_decoder layer, not TINY's five stacks: the JAX side's traces of
# its layers take most of this file's time, and what the dialog models add
# sits around the backbone (the U-Net's stacks are held against JAX in
# test_torch_zipformer.py and test_torch_zipvoice.py)
CONFIG = dict(TINY, fm_decoder_downsampling_factor=(1,),
              fm_decoder_num_layers=(1,), fm_decoder_cnn_module_kernel=(7,))
DS = dict(DS, fm_decoder=CONFIG["fm_decoder_downsampling_factor"])
F = TINY["feat_dim"]
S1, S2 = SPK["spk_a_id"], SPK["spk_b_id"]


def _pair(stereo: bool, seed: int):
    """(flax model, flax params, port model, the perturbed reference
    state_dict) with the same weights."""
    from zipvoice_tpu.models import dialog as jax_dialog
    from zipvoice_tpu.utils.convert import convert_zipvoice

    cls = ZipVoiceDialogStereo if stereo else ZipVoiceDialog
    rng = np.random.RandomState(seed)
    source = build_zipvoice(model_class=cls, device="cpu", seed=seed,
                            **CONFIG, **SPK)
    ref_sd = {
        k: v.numpy()
        + np.float32(0.05) * np.asarray(rng.randn(*v.shape), np.float32)
        for k, v in source.state_dict().items()
    }
    params = {"params": convert_zipvoice(ref_sd)}
    port = build_zipvoice(model_class=cls, device="cpu", **CONFIG, **SPK)
    port.load_state_dict(
        state_dict_from_jax_params(params["params"], DS), strict=True
    )
    jcls = (jax_dialog.ZipVoiceDialogStereo if stereo
            else jax_dialog.ZipVoiceDialog)
    return jcls(**CONFIG, **SPK), params, port, ref_sd


def _jax_outputs(jmodel, params, cases):
    """Every compared JAX output of one model from ONE jitted program (a
    compile per program costs more than these tiny programs run for):
    ``cases`` maps a name to (method or None for the loss, static keyword
    arguments, numpy inputs)."""
    def run(params, inputs):
        out = {}
        for name, (method, static, _) in cases.items():
            kw = dict(static, **({"method": method} if method else
                                 {"train": False}))
            out[name] = jmodel.apply(params, **inputs[name], **kw)
        return out

    inputs = {name: to_jax(x) for name, (_, _, x) in cases.items()}
    out = jax_jit(run)(params, inputs)
    return jax.tree.map(np.asarray, out)


SAMPLE_KW = dict(num_step=2, guidance_scale=1.5, t_shift=0.5)


@pytest.fixture(scope="module")
def mono():
    jmodel, params, port, ref_sd = _pair(False, 0)
    tokens, lens = _tokens()
    cases = {
        "spk_indices": ("spk_indices", {}, {"tokens": tokens}),
        "text_embed": ("forward_text_embed", {},
                       {"tokens": tokens, "tokens_lens": lens}),
        "loss": (None, {}, _loss_inputs(F, seed=6)),
        "sample": ("sample", SAMPLE_KW, _sample_inputs(F, seed=11)),
    }
    return params, port, ref_sd, cases, _jax_outputs(jmodel, params, cases)


@pytest.fixture(scope="module")
def stereo():
    jmodel, params, port, ref_sd = _pair(True, 1)
    cases = {f"fm_{w}": ("forward_fm_decoder", {}, _fm_inputs(w))
             for w in (2 * F, F)}
    cases.update({
        "loss_se1": (None, {"se_weight": 1.0}, _loss_inputs(2 * F, seed=7)),
        "loss_se0": (None, {"se_weight": 0.0}, _loss_inputs(F, seed=8)),
        "energy": ("energy_based_loss", {}, _energy_inputs()),
        "sample": ("sample", SAMPLE_KW, _sample_inputs(2 * F, seed=12)),
    })
    return params, port, ref_sd, cases, _jax_outputs(jmodel, params, cases)


def _tokens():
    """Four rows of prompt + text ids: an odd number of turns, an even
    number, a leading [S2], and a short row with padding."""
    rows = [
        [S1, 3, 4, 5, S2, 6, 7, S1, 8, 9, 10, 11, 12, 13],
        [S1, 3, 4, S2, 5, 6, S1, 7, 8, S2, 9, 10, 11, 12],
        [S2, 3, 4, 5, 6, S1, 7, 8, 9, S2, 10, 11, 12, 13],
        [S1, 5, 6, S2, 7, 8, 9],
    ]
    tokens = np.zeros((4, 16), np.int64)
    for i, r in enumerate(rows):
        tokens[i, : len(r)] = r
    return tokens, np.array([len(r) for r in rows])


def _fm_inputs(width):
    """fm_decoder inputs whose x_t and speech condition are ``width``
    wide (2F: the two-channel stream, 5F in all; F: the mixed stream, 3F),
    the second row padded."""
    rng = np.random.RandomState(width)
    B, T = 2, 27
    pm = np.zeros((B, T), bool)
    pm[1, 19:] = True
    return dict(
        t=np.array([0.3, 0.8], np.float32),
        xt=rng.randn(B, T, width).astype(np.float32),
        text_condition=rng.randn(B, T, F).astype(np.float32),
        speech_condition=rng.randn(B, T, width).astype(np.float32),
        padding_mask=pm,
    )


def _loss_inputs(width, seed):
    """Loss inputs at fixed t, noise and masks: the four token rows, two of
    them padded in time, the span mask anchored at the end of each row."""
    rng = np.random.RandomState(seed)
    tokens, tokens_lens = _tokens()
    B, T = 4, 40
    features_lens = np.array([40, 36, 40, 25])
    features = rng.randn(B, T, width).astype(np.float32)
    features[np.arange(T)[None, :] >= features_lens[:, None]] = 0.0
    starts = np.array([10, 18, 20, 9])
    mask = ((np.arange(T)[None, :] >= starts[:, None])
            & (np.arange(T)[None, :] < features_lens[:, None]))
    return dict(
        tokens=tokens, tokens_lens=tokens_lens, features=features,
        features_lens=features_lens,
        noise=rng.randn(B, T, width).astype(np.float32),
        t=rng.uniform(0.1, 0.9, (B, 1, 1)).astype(np.float32),
        condition_drop_mask=np.array([False, True, False, False]),
        speech_condition_mask=mask,
    )


def _energy_inputs():
    """Two channels' predicted features and a ground truth whose second
    and third rows are zero-padded in time."""
    rng = np.random.RandomState(9)
    B, T = 3, 21
    gt = rng.randn(B, T, 2 * F).astype(np.float32)
    gt[1, 15:] = 0.0
    gt[2, 8:] = 0.0
    return dict(
        fbank1=rng.randn(B, T, F).astype(np.float32) + 0.3,
        fbank2=rng.randn(B, T, F).astype(np.float32) + 0.3,
        gt_fbank=gt,
    )


def _sample_inputs(width, seed):
    """Two rows of prompt + text ids (the second padded, starting with
    [S2]) with prompt features and noise ``width`` wide."""
    rng = np.random.RandomState(seed)
    rows = [[S1, 3, 4, S2, 5, 6, S1, 7, 8, 9, 10, 11, 12, 13],
            [S2, 5, 6, 7, S1, 8, 9, 10, 11]]
    tokens = np.zeros((2, 16), np.int64)
    for i, r in enumerate(rows):
        tokens[i, : len(r)] = r
    T = 27
    prompt_features_lens = np.array([6, 4])
    prompt_features = np.zeros((2, T, width), np.float32)
    for i, n in enumerate(prompt_features_lens):
        prompt_features[i, :n] = rng.randn(n, width)
    return dict(
        tokens=tokens, tokens_lens=np.array([len(r) for r in rows]),
        prompt_tokens_lens=np.array([4, 3]),
        prompt_features=prompt_features,
        prompt_features_lens=prompt_features_lens,
        features_lens=np.array([23, 17]),
        noise=rng.randn(2, T, width).astype(np.float32),
    )


def _port_output(port, cases, name):
    """The port's counterpart of the JAX case ``name``."""
    method, static, x = cases[name]
    with torch.no_grad():
        if method is None:
            return port(**to_torch(x), train=False, **static)
        return getattr(port, method)(**to_torch(x), **static)


@pytest.mark.parametrize("stereo_model", [False, True])
def test_state_dict_round_trip(stereo_model, mono, stereo):
    """The reference state_dict goes to flax params and back unchanged,
    and JAX's own ``invert_zipvoice`` gives the port's keys and values:
    ``spk_embed.weight`` and, for stereo, the two projection pairs."""
    from zipvoice_tpu.utils.convert import invert_zipvoice

    params, port, ref_sd, _, _ = stereo if stereo_model else mono
    got = port.state_dict()
    assert sorted(got) == sorted(ref_sd)
    for k, v in ref_sd.items():
        assert torch.equal(got[k], torch.from_numpy(np.asarray(v))), k
    inverted = invert_zipvoice(params["params"], DS)
    assert sorted(inverted) == sorted(got)
    for k, v in inverted.items():
        assert torch.equal(got[k], torch.from_numpy(np.asarray(v))), k
    assert "spk_embed.weight" in got
    pairs = {f"fm_decoder.{p}.{i}.{w}" for p in ("in_proj", "out_proj")
             for i in (0, 1) for w in ("weight", "bias")}
    if stereo_model:
        assert pairs <= set(got)
        assert got["fm_decoder.in_proj.0.weight"].shape[1] == 5 * F
        assert got["fm_decoder.in_proj.1.weight"].shape[1] == 3 * F
        assert got["fm_decoder.out_proj.0.weight"].shape[0] == 2 * F
        assert got["fm_decoder.out_proj.1.weight"].shape[0] == F
    else:
        assert not pairs & set(got)
        assert "fm_decoder.in_proj.weight" in got


def test_spk_indices_and_text_embed(mono):
    """The speaker index of every position equals JAX's and the parity
    written out by hand (-1 at pads): odd and even numbers of turns, a
    leading [S2], padding.  The text embedding with the speaker embedding
    added matches within 2e-4."""
    _, port, _, cases, want = mono
    got = _port_output(port, cases, "spk_indices").numpy()
    np.testing.assert_array_equal(got, want["spk_indices"])
    np.testing.assert_array_equal(
        got[0, :15], [1, 1, 1, 1, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, -1])
    np.testing.assert_array_equal(got[2, :6], [1, 1, 1, 1, 1, 0])
    np.testing.assert_array_equal(got[3], [1, 1, 1, 0, 0, 0, 0] + [-1] * 9)
    got = _port_output(port, cases, "text_embed").numpy()
    np.testing.assert_allclose(got, want["text_embed"], atol=2e-4, rtol=0)


def test_two_stream_decoder(stereo):
    """The stereo model's fm_decoder on both streams, 5F (two-channel)
    and 3F (mixed-channel) inputs, within 2e-4; another width raises."""
    _, port, _, cases, want = stereo
    for width in (2 * F, F):
        name = f"fm_{width}"
        got = _port_output(port, cases, name).numpy()
        assert got.shape == want[name].shape == (2, 27, width)
        valid = ~cases[name][2]["padding_mask"]
        np.testing.assert_allclose(got[valid], want[name][valid], atol=2e-4,
                                   rtol=0)
    with pytest.raises(ValueError, match="neither stream"):
        port.fm_decoder(torch.zeros(2, 27, 4 * F), t=torch.zeros(2))


@pytest.mark.parametrize("case", ["loss", "loss_se1", "loss_se0"])
def test_losses(case, mono, stereo):
    """The dialog loss, and the stereo loss with the energy term (2F
    features, se_weight 1) and without it (F features, se_weight 0), the
    squared error averaged over the masked frames and the features'
    width, within 1e-4."""
    _, port, _, cases, want = mono if case == "loss" else stereo
    got = float(_port_output(port, cases, case))
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want[case], atol=1e-4, rtol=0)


def test_energy_loss_on_a_padded_batch(stereo):
    """The energy penalty alone: the median over both channels' 2T frames
    takes the zero-padded frames in, as JAX's does (within 1e-6)."""
    _, port, _, cases, want = stereo
    got = _port_output(port, cases, "energy").numpy()
    assert (got > 0).any() and (got == 0).any()
    np.testing.assert_allclose(got, want["energy"], atol=1e-6, rtol=0)


def test_suffix_mask_matches_jax():
    """The dialog models' training span (``mask_percent`` (0.5, 1.0),
    anchored at the row's end) from the same uniform draws as JAX's
    ``condition_time_mask(..., suffix=True)``."""
    from zipvoice_tpu.models.conditioning import (
        condition_time_mask as jax_mask,
    )

    lens = np.array([40, 33, 17, 1])
    # the mask and its two draws from one JAX program
    want, u = jax_jit(lambda seed, lens: (
        jax_mask(jax.random.PRNGKey(seed), lens, 44, (0.5, 1.0),
                 suffix=True),
        [jax.random.uniform(k, (4,))
         for k in jax.random.split(jax.random.PRNGKey(seed))]))(
        np.int32(3), jnp.asarray(lens))
    want = np.asarray(want)
    u = [torch.tensor(np.asarray(v)) for v in u]
    got = condition_time_mask(*u, torch.from_numpy(lens), 44,
                              mask_percent=ZipVoiceDialog.mask_percent,
                              suffix=ZipVoiceDialog.mask_suffix).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[:, -1].sum() == 0 and got[0, 39] and not got[0, 0]


@pytest.mark.parametrize("stereo_model", [False, True])
def test_sample_matches_jax(stereo_model, mono, stereo):
    """``sample`` over 2 steps with CFG: the same padding mask, features
    within 5e-3 (stereo: (T, 2F) features through stream 0)."""
    _, port, _, cases, want = stereo if stereo_model else mono
    x1, pm = _port_output(port, cases, "sample")
    x1_j, pm_j = want["sample"]
    np.testing.assert_array_equal(pm.numpy(), pm_j)
    assert x1.shape == x1_j.shape
    valid = ~pm_j
    np.testing.assert_allclose(x1.numpy()[valid], x1_j[valid], atol=5e-3,
                               rtol=0)
