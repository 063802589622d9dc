"""Port parity: the fused weights + NonlinAttention kernel, the attention
application kernel and the kernel configuration of the Zipformer
(zipvoice_torch) vs the JAX package.

The kernels' plain versions are held against the Pallas kernels run in
interpret mode; one encoder layer in the kernel configuration against the
JAX layer on its Pallas paths (FUSE_NONLIN and APPLY_KERNEL on, thresholds
lowered to the test's T); ``ZipVoice.sample`` in the kernel configuration
against the JAX package's plain path.  The CUDA kernels are held against
their plain versions in test_torch_gpu.py.
"""

import numpy as np

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

import zipvoice_torch.models.zipformer as zipformer
from torch_parity import (
    assert_params_like_init,
    assert_sample_matches,
    jax_jit,
    jax_pos_encoding,
)
from zipvoice_torch.kernels.rel_pos_attention import (
    attention_apply_ref,
    rel_pos_attention_weights_nonlin_ref,
)
from zipvoice_torch.models.zipformer import (
    ZipformerEncoderLayer,
    compact_rel_pos_encoding,
    set_kernel_config,
)
from zipvoice_torch.utils.convert import zipformer_state_dict


def _attention_inputs(T, B=3, h=4, qd=8, pd=4, hid=24, seed=0):
    """Row 0 unpadded, row 1 with padded keys, row 2 fully masked; nv
    (B, T, hid) NonlinAttention's gated values."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, h, T, qd).astype(np.float32)
    k = rng.randn(B, h, T, qd).astype(np.float32)
    p = (0.3 * rng.randn(B, h, T, pd)).astype(np.float32)
    pe = rng.randn(h, 2 * T - 1, pd).astype(np.float32)
    lens = np.array([T, T - T // 3, 0])[:B]
    mask = np.arange(T)[None, :] >= lens[:, None]
    nv = rng.randn(B, T, hid).astype(np.float32)
    return q, k, p, pe, mask, nv


def test_nonlin_plain_version_matches_pallas_interpret():
    from zipvoice_tpu.ops.pallas_attention import (
        rel_pos_attention_weights_nonlin as jax_nonlin,
    )

    arrays = _attention_inputs(128)
    want_w, want_na = jax_jit(lambda *a: jax_nonlin(*a, interpret=True))(
        *map(jnp.asarray, arrays))
    got_w, got_na = rel_pos_attention_weights_nonlin_ref(
        *map(torch.from_numpy, arrays))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), atol=2e-6,
                               rtol=0)
    np.testing.assert_allclose(got_na.numpy(), np.asarray(want_na),
                               atol=1e-4, rtol=0)


def test_apply_plain_version_matches_pallas_interpret():
    from zipvoice_tpu.ops.pallas_attention import (
        attention_apply as jax_apply,
    )

    rng = np.random.RandomState(1)
    w = rng.rand(2, 4, 128, 128).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    v = rng.randn(2, 4, 128, 12).astype(np.float32)
    want = np.asarray(jax_jit(lambda *a: jax_apply(*a, interpret=True))(
        jnp.asarray(w), jnp.asarray(v)))
    got = attention_apply_ref(torch.from_numpy(w), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


def test_layer_kernel_config_matches_jax(monkeypatch):
    """One encoder layer, inference, f32: the port in the kernel
    configuration (fused weights + NonlinAttention, the application kernel
    and the conv kernel, all as their plain versions on the CPU) against
    the JAX layer with its fused and application kernels in interpret mode
    and its lax conv.  T = 48 (a multiple of 8, as the JAX kernels need),
    row 1 with a padded tail."""
    from zipvoice_tpu.models.zipformer import ZipformerEncoderLayer as JaxLayer
    from zipvoice_tpu.ops import pallas_attention as pa
    from zipvoice_tpu.utils.convert import convert_tts_zipformer

    T, D = 48, 48
    # the switches are read when the JAX program is traced, so they are set
    # before this test's own jitted function first runs
    monkeypatch.setattr(pa, "FUSE_NONLIN", True)
    monkeypatch.setattr(pa, "APPLY_KERNEL", True)
    monkeypatch.setattr(pa, "MIN_SEQ_LEN", T)
    monkeypatch.setattr(pa, "MIN_APPLY_SEQ_LEN", T)
    monkeypatch.setattr(zipformer, "MIN_SEQ_LEN", T)
    monkeypatch.setattr(zipformer, "MIN_APPLY_SEQ_LEN", T)

    kw = dict(embed_dim=D, pos_dim=48, num_heads=4, query_head_dim=8,
              pos_head_dim=4, value_head_dim=12, feedforward_dim=64,
              cnn_module_kernel=7)
    rng = np.random.RandomState(4)
    x = rng.randn(2, T, D).astype(np.float32)
    time_emb = rng.randn(2, 1, D).astype(np.float32)
    mask = np.zeros((2, T), bool)
    mask[1, -13:] = True
    pos = jax_pos_encoding(T, 48)
    jlayer = JaxLayer(**kw, use_pallas_attention=True)
    args = tuple(map(jnp.asarray, (x, pos, time_emb, mask)))
    # flax params from the port's init, perturbed, through the JAX
    # package's converter: a flax init would trace the layer once more
    tlayer = ZipformerEncoderLayer(**kw)
    params = {"params": convert_tts_zipformer({
        k: v.numpy() + np.float32(0.05)
        * np.asarray(rng.randn(*v.shape), np.float32)
        for k, v in tlayer.state_dict().items()})}
    want = np.asarray(jax_jit(jlayer.apply)(params, *args))
    assert_params_like_init(params, jlayer.init, *args)

    tlayer.load_state_dict(zipformer_state_dict(params["params"]),
                           strict=True)
    set_kernel_config(tlayer, True)
    with torch.no_grad():
        got = tlayer(torch.from_numpy(x), compact_rel_pos_encoding(T, 48),
                     torch.from_numpy(time_emb), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


def test_sample_kernel_config_matches_jax(monkeypatch):
    """``ZipVoice.sample`` with every kernel switch on and the thresholds
    lowered so that each level of 8 frames or more takes the fused, the
    application and the conv kernels' paths, against the JAX package's
    plain path."""
    monkeypatch.setattr(zipformer, "MIN_SEQ_LEN", 8)
    monkeypatch.setattr(zipformer, "MIN_APPLY_SEQ_LEN", 8)
    assert_sample_matches(False, 1.0, kernel_config=True)
