"""Port parity: rel-pos attention weights (zipvoice_torch) vs the JAX package.

The kernel's plain version is held against the Pallas kernel run in
interpret mode and the module against the flax module on both of its paths.
The CUDA kernel is held against its plain version in test_torch_gpu.py.
"""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

from torch_parity import (  # noqa: F401
    assert_params_like_init,
    jax_jit,
    jax_pos_encoding,
    one_torch_thread,
)
from zipvoice_torch.kernels.rel_pos_attention import (
    rel_pos_attention_weights_ref,
)
from zipvoice_torch.models.zipformer import (
    RelPosAttentionWeights,
    compact_rel_pos_encoding,
    set_attention_kernel,
    set_compute_dtype,
)
from zipvoice_torch.utils.convert import to_flax, zipformer_state_dict

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _inputs(T, B=3, h=4, qd=8, pd=4, seed=0):
    """Row 0 unpadded, row 1 with padded keys, row 2 fully masked."""
    rng = np.random.RandomState(seed)
    q = rng.randn(B, h, T, qd).astype(np.float32)
    k = rng.randn(B, h, T, qd).astype(np.float32)
    p = (rng.randn(B, h, T, pd) * 0.3).astype(np.float32)
    pe = rng.randn(h, 2 * T - 1, pd).astype(np.float32)
    lens = np.array([T, T - T // 3, 0])[:B]
    mask = np.arange(T)[None, :] >= lens[:, None]
    return q, k, p, pe, mask


@pytest.mark.parametrize("T", [64, 128])
def test_plain_version_matches_pallas_interpret(T):
    from zipvoice_tpu.ops.pallas_attention import (
        rel_pos_attention_weights as jax_weights,
    )

    arrays = _inputs(T)
    want = np.asarray(jax_jit(lambda *a: jax_weights(*a, interpret=True))(
        *map(jnp.asarray, arrays)))
    got = rel_pos_attention_weights_ref(*map(torch.from_numpy, arrays))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)
    # the fully masked row stays finite and uniform
    np.testing.assert_allclose(got[2].numpy(), 1.0 / T, rtol=1e-6)


def _module_pair(T, D=32, dtype=jnp.float32, seed=0):
    from zipvoice_tpu.models.zipformer import (
        RelPosAttentionWeights as JaxWeights,
    )

    kw = dict(embed_dim=D, pos_dim=48, num_heads=4, query_head_dim=8,
              pos_head_dim=4)
    rng = np.random.RandomState(seed)
    x = rng.randn(2, T, D).astype(np.float32)
    mask = np.zeros((2, T), bool)
    mask[1, -(T // 4):] = True
    jmod = JaxWeights(**kw, dtype=dtype)
    pos = jnp.asarray(jax_pos_encoding(T, 48))
    # the flax params from a seeded port module (no flax init to compile),
    # checked against the tree flax's init makes
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        source = RelPosAttentionWeights(**kw)
    params = {"params": {
        name: {("kernel" if leaf == "weight" else leaf):
               to_flax(f"{name}.{leaf}", v.detach().numpy())
               for leaf, v in getattr(source, name).named_parameters()}
        for name in ("in_proj", "linear_pos")}}
    assert_params_like_init(params, jmod.init, jnp.asarray(x), pos)
    want = np.asarray(jax_jit(lambda p, x, pos, mask: jmod.apply(
        p, x, pos.astype(dtype), mask).astype(jnp.float32))(
        params, jnp.asarray(x), pos, jnp.asarray(mask)))
    tmod = RelPosAttentionWeights(**kw)
    tmod.load_state_dict(zipformer_state_dict(params["params"]), strict=True)
    return tmod, x, mask, want


def test_module_plain_path_f32():
    T = 37
    tmod, x, mask, want = _module_pair(T)
    set_attention_kernel(tmod, False)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), compact_rel_pos_encoding(T, 48),
                   torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


def test_module_plain_path_bf16():
    """The bf16 branch (bf16 exp, f32 normalizer) against JAX's, within
    one bf16 ulp of weights in [0, 1]."""
    T = 40
    tmod, x, mask, want = _module_pair(T, dtype=jnp.bfloat16)
    set_attention_kernel(tmod, False)
    set_compute_dtype(tmod, torch.bfloat16)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x),
                   compact_rel_pos_encoding(T, 48).to(torch.bfloat16),
                   torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=8e-3, rtol=0)
    # and element by element, so that small weights are held too: both
    # sides round the scores to bf16 before a bf16 exp, which moves a
    # weight by a few bf16 roundings (2^-7 each), never by 2^-4 of itself
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=2.0 ** -4)


def test_module_kernel_gate_ragged_T(monkeypatch):
    """With the gate open, a T that is no multiple of 8 goes through the
    kernel wrapper (its plain version on the CPU) and agrees with JAX."""
    import zipvoice_torch.models.zipformer as zipformer

    T = 37
    tmod, x, mask, want = _module_pair(T, seed=1)
    monkeypatch.setattr(zipformer, "MIN_SEQ_LEN", T)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), compact_rel_pos_encoding(T, 48),
                   torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)

