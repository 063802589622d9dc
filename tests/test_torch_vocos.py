"""Port parity: iSTFT and the Vocos vocoder (zipvoice_torch) vs the JAX
package, f32 on CPU; and the port's import isolation."""

import os
import subprocess
import sys

import numpy as np

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

from torch_parity import TINY_VOCOS, assert_params_like_init, jax_jit
from zipvoice_torch.ops.stft import istft
from zipvoice_torch.utils.convert import vocos_state_dict_from_jax_params
from zipvoice_torch.vocoder.vocos import build_vocos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_istft_matches_jax():
    from zipvoice_tpu.ops.stft import istft as jax_istft

    rng = np.random.RandomState(0)
    re, im = (rng.randn(2, 9, 513).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_jit(lambda *a: jax_istft(*a, length=9 * 256))(
        jnp.asarray(re), jnp.asarray(im)))
    got = istft(torch.from_numpy(re), torch.from_numpy(im), length=9 * 256)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    # without a length, center padding is trimmed from both ends
    got = istft(torch.from_numpy(re), torch.from_numpy(im))
    assert got.shape[-1] == 8 * 256


def test_vocos_matches_jax():
    from zipvoice_tpu.vocoder.vocos import Vocos as JaxVocos
    from zipvoice_tpu.vocoder.vocos import convert_vocos_state_dict

    rng = np.random.RandomState(1)
    mel = (0.5 * rng.randn(2, 13, TINY_VOCOS["n_mels"])).astype(np.float32)
    jvocos = JaxVocos(**TINY_VOCOS)
    # flax params from the port's seeded init, perturbed, through the JAX
    # package's converter: a flax init would trace the vocoder once more
    vocos = build_vocos(device="cpu", **TINY_VOCOS)
    params = {"params": convert_vocos_state_dict({
        k: v.numpy() + np.float32(0.05)
        * np.asarray(rng.randn(*v.shape), np.float32)
        for k, v in vocos.state_dict().items()})}
    want = np.asarray(jax_jit(jvocos.apply)(params, jnp.asarray(mel)))
    assert_params_like_init(params, jvocos.init, jnp.asarray(mel))
    vocos.load_state_dict(vocos_state_dict_from_jax_params(params["params"]),
                          strict=True)
    with torch.no_grad():
        got = vocos(torch.from_numpy(mel)).numpy()
    assert got.shape == (2, 13 * 256)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_port_imports_no_jax():
    """Importing every zipvoice_torch module, the training step, every
    kernel wrapper, the front end, the dialog models and pipelines, the
    CLIs and the serving modules among them, leaves jax, the JAX package,
    tools/ and egs/ out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys, zipvoice_torch\n"
        "for m in pkgutil.walk_packages(zipvoice_torch.__path__,"
        " 'zipvoice_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'zipvoice_tpu', 'tools', 'egs'))\n"
        "assert not bad, bad\n"
        "need = {'zipvoice_torch.train.train_step',"
        " 'zipvoice_torch.train.optim', 'zipvoice_torch.ops.schedule',"
        " 'zipvoice_torch.ops.scaling',"
        " 'zipvoice_torch.kernels.rel_pos_attention',"
        " 'zipvoice_torch.kernels.depthwise_conv',"
        " 'zipvoice_torch.frontend.tokenizer', 'zipvoice_torch.frontend.g2p',"
        " 'zipvoice_torch.frontend.en_g2p', 'zipvoice_torch.frontend.zh_g2p',"
        " 'zipvoice_torch.frontend.feature', 'zipvoice_torch.frontend.audio',"
        " 'zipvoice_torch.utils.checkpoint_io',"
        " 'zipvoice_torch.bin.infer_zipvoice',"
        " 'zipvoice_torch.models.dialog',"
        " 'zipvoice_torch.infer.dialog_pipeline',"
        " 'zipvoice_torch.bin.infer_zipvoice_dialog',"
        " 'zipvoice_torch.serving.quantize', 'zipvoice_torch.serving.server',"
        " 'zipvoice_torch.serving.client'}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "print(len([m for m in sys.modules"
        " if m.startswith('zipvoice_torch.')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 46
