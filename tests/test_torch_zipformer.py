"""Port parity: the Zipformer backbones, the weight converter and the
integer conditioning (zipvoice_torch) vs the JAX package, f32 on CPU."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

from torch_parity import (  # noqa: F401
    DS,
    TINY,
    jax_jit,
    jax_method,
    model_pair,
    one_torch_thread,
    sample_inputs,
)
from zipvoice_torch.models.conditioning import (
    avg_upsample_index,
    predict_features_lens,
)
from zipvoice_torch.models.zipvoice import strip_prompt
from zipvoice_torch.utils.convert import state_dict_from_jax_params

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def base_pair():
    return model_pair()


def test_converter_matches_invert_zipvoice(base_pair):
    from zipvoice_tpu.utils.convert import invert_zipvoice

    _, params, _ = base_pair
    want = invert_zipvoice(params["params"], downsampling_factors=DS)
    got = state_dict_from_jax_params(params["params"], DS)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_text_encoder_forward(base_pair):
    jmodel, params, tmodel = base_pair
    x = sample_inputs()
    want = jax_method(jmodel, "forward_text_embed")(
        params, {"tokens": jnp.asarray(x["tokens"]),
                 "tokens_lens": jnp.asarray(x["tokens_lens"])},
    )
    with torch.no_grad():
        got = tmodel.forward_text_embed(torch.from_numpy(x["tokens"]),
                                        torch.from_numpy(x["tokens_lens"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=0)


def test_fm_decoder_forward_with_padding(base_pair):
    """27 frames (no multiple of 4) and rows of 23 and 17 valid frames:
    the downsampled levels repeat the last valid frame and take
    mask[:, ::ds]."""
    jmodel, params, tmodel = base_pair
    rng = np.random.RandomState(7)
    B, T, F = 2, 27, TINY["feat_dim"]
    t = np.array([0.3, 0.7], np.float32)
    xt, tc, sc = (rng.randn(B, T, F).astype(np.float32) for _ in range(3))
    mask = np.arange(T)[None, :] >= np.array([[23], [17]])
    want = jax_method(jmodel, "forward_fm_decoder")(params, {
        "t": jnp.asarray(t), "xt": jnp.asarray(xt),
        "text_condition": jnp.asarray(tc),
        "speech_condition": jnp.asarray(sc),
        "padding_mask": jnp.asarray(mask),
    })
    with torch.no_grad():
        got = tmodel.forward_fm_decoder(
            *map(torch.from_numpy, (t, xt, tc, sc, mask))
        )
    valid = ~mask
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=2e-4, rtol=0)


def test_integer_conditioning_exact():
    from zipvoice_tpu.models import conditioning as jc
    from zipvoice_tpu.models.zipvoice import strip_prompt as jax_strip

    rng = np.random.RandomState(0)
    B, T = 64, 300
    speeds = (1.0, 0.8, 1.3)
    tokens_lens = rng.randint(0, 120, B)
    features_lens = rng.randint(0, T + 1, B)
    pfl = rng.randint(1, 200, B)
    ptl = rng.randint(1, 60, B)
    x1 = rng.randn(B, T, 3).astype(np.float32)
    mask = np.arange(T)[None, :] >= features_lens[:, None]
    kept = np.minimum(pfl, features_lens)
    # the JAX side as one program (eagerly, each op would compile alone)
    want_index, want_lens, (want_x, want_strip) = jax_jit(
        lambda tl, fl, pfl, ptl, x1, mask, kept: (
            jc.avg_upsample_index(tl, fl, T),
            [jc.predict_features_lens(pfl, ptl, tl, s) for s in speeds],
            jax_strip(x1, mask, kept)))(
        *map(jnp.asarray, (tokens_lens, features_lens, pfl, ptl, x1, mask,
                           kept)))

    got = avg_upsample_index(torch.from_numpy(tokens_lens),
                             torch.from_numpy(features_lens), T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_index))
    for speed, want in zip(speeds, want_lens):
        got = predict_features_lens(
            *map(torch.from_numpy, (pfl, ptl, tokens_lens)), speed
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    got_x, got_lens = strip_prompt(*map(torch.from_numpy, (x1, mask, kept)))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_strip))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
