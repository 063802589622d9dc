"""Port parity: the depthwise-conv kernels' plain versions and the
ConvolutionModule's kernel path (zipvoice_torch) vs the JAX package.

The JAX side runs its Pallas kernels in interpret mode.  The CUDA kernels
are held against these plain versions in test_torch_gpu.py.
"""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from torch_parity import assert_params_like_init, jax_jit
from zipvoice_torch.kernels.depthwise_conv import (
    depthwise_conv1d,
    depthwise_conv1d_ref,
    depthwise_conv1d_trainable,
)
from zipvoice_torch.models.zipformer import ConvolutionModule, set_conv_kernel
from zipvoice_torch.utils.convert import zipformer_state_dict


def _inputs(k, B=2, T=40, C=24, seed=0):
    """v (B, T, C), the JAX filter (k, C) and the bias (C,), f32."""
    rng = np.random.RandomState(seed + k)
    return (rng.randn(B, T, C).astype(np.float32),
            (0.3 * rng.randn(k, C)).astype(np.float32),
            (0.3 * rng.randn(C)).astype(np.float32))


@pytest.mark.parametrize("k", [7, 9, 15, 31])
def test_plain_version_matches_pallas_interpret(k):
    """Every kernel size of the models, k=31 wider than a third of T."""
    from zipvoice_tpu.ops.pallas_conv import depthwise_conv1d as jax_conv

    v, w, b = _inputs(k)
    want = np.asarray(jax_jit(lambda *a: jax_conv(*a, interpret=True))(
        *map(jnp.asarray, (v, w, b))))
    got = depthwise_conv1d_ref(torch.from_numpy(v),
                               torch.from_numpy(w.T.copy()),
                               torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the wrapper takes the plain version for CPU tensors
    same = depthwise_conv1d(torch.from_numpy(v), torch.from_numpy(w.T.copy()),
                            torch.from_numpy(b))
    assert torch.equal(same, got)


@pytest.mark.parametrize("k,T", [(7, 48), (9, 48), (15, 48), (31, 48),
                                 (9, 5)])
def test_trainable_grads_match_pallas_vjp(k, T):
    """dv, dw and db of the port's differentiable conv (on the CPU, the
    plain backward) against the Pallas backward kernel's, within 1e-5 of
    each tensor's largest |value|: every kernel size of the models, and
    T < k (5 rows under a 9-tap filter, mostly SAME padding)."""
    from zipvoice_tpu.ops.pallas_conv import depthwise_conv1d_vjp

    v, w, b = _inputs(k, T=T, seed=1)
    g = np.random.RandomState(2).randn(*v.shape).astype(np.float32)

    def loss(v, w, b):
        return jnp.sum(depthwise_conv1d_vjp(v, w, b, True) * jnp.asarray(g))

    want = jax_jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (v, w, b)))
    tv, tw, tb = (torch.from_numpy(a).requires_grad_(True)
                  for a in (v, w.T.copy(), b))
    (depthwise_conv1d_trainable(tv, tw, tb) * torch.from_numpy(g)).sum() \
        .backward()
    for got, ref in zip((tv.grad, tw.grad.T, tb.grad), want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_conv_module_kernel_path_matches_jax():
    """ConvolutionModule with the kernel switched on against the JAX
    module on its Pallas path, with padded frames."""
    from zipvoice_tpu.models.zipformer import (
        ConvolutionModule as JaxConvModule,
    )
    from zipvoice_tpu.utils.convert import convert_tts_zipformer

    C, k, T = 32, 9, 40
    rng = np.random.RandomState(3)
    x = rng.randn(2, T, C).astype(np.float32)
    mask = np.zeros((2, T), bool)
    mask[1, -11:] = True
    jmod = JaxConvModule(channels=C, kernel_size=k, use_pallas=True,
                         pallas_interpret=True)
    # flax params from the port's init, perturbed, through the JAX
    # package's converter: a flax init would trace the Pallas path again
    tmod = set_conv_kernel(ConvolutionModule(C, k), True)
    params = {"params": convert_tts_zipformer({
        name: v.numpy() + np.float32(0.05)
        * np.asarray(rng.randn(*v.shape), np.float32)
        for name, v in tmod.state_dict().items()})}
    want = np.asarray(jax_jit(jmod.apply)(params, jnp.asarray(x),
                                          jnp.asarray(mask)))
    assert_params_like_init(params, jmod.init, jnp.asarray(x),
                            jnp.asarray(mask))
    tmod.load_state_dict(zipformer_state_dict(params["params"]), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
