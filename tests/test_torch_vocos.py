"""Port parity: iSTFT and the Vocos vocoder (zipvoice_torch) vs the JAX
package, f32 on CPU; and the port's import isolation."""

import os

import numpy as np

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

from torch_parity import TINY_VOCOS, assert_params_like_init, jax_jit
from zipvoice_torch.ops.stft import istft
from zipvoice_torch.utils.convert import vocos_state_dict_from_jax_params
from zipvoice_torch.vocoder.vocos import build_vocos


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
    kernel wrapper, the front end (the eight first-party G2Ps included),
    the dialog models and pipelines, the CLIs, the serving modules (the
    gRPC pair among them), the process group and the tensor-parallel plans,
    and the evaluation modules among them, leaves jax, the JAX package,
    tools/ and egs/ out of sys.modules.  The modules are imported in a
    process forked from the forkserver that tests/test_torch_parallel.py
    uses (``torch_parallel_worker.FORKSERVER_PRELOAD``: torch and a few
    port modules, no JAX), which saves this test a torch import."""
    import json
    import multiprocessing
    import tempfile

    import torch_parallel_worker as worker

    need = {
        "zipvoice_torch.train.train_step", "zipvoice_torch.train.optim",
        "zipvoice_torch.ops.schedule", "zipvoice_torch.ops.scaling",
        "zipvoice_torch.kernels.rel_pos_attention",
        "zipvoice_torch.kernels.depthwise_conv",
        "zipvoice_torch.frontend.tokenizer", "zipvoice_torch.frontend.g2p",
        "zipvoice_torch.frontend.en_g2p", "zipvoice_torch.frontend.zh_g2p",
        "zipvoice_torch.frontend.feature", "zipvoice_torch.frontend.audio",
        "zipvoice_torch.utils.checkpoint_io",
        "zipvoice_torch.bin.infer_zipvoice", "zipvoice_torch.models.dialog",
        "zipvoice_torch.infer.dialog_pipeline",
        "zipvoice_torch.bin.infer_zipvoice_dialog",
        "zipvoice_torch.serving.quantize", "zipvoice_torch.serving.server",
        "zipvoice_torch.serving.client", "zipvoice_torch.serving.aot",
        "zipvoice_torch.bin.export_model", "zipvoice_torch.bin.infer_exported",
        "zipvoice_torch.utils.diagnostics", "zipvoice_torch.parallel.mesh",
        "zipvoice_torch.frontend.es_g2p", "zipvoice_torch.frontend.de_g2p",
        "zipvoice_torch.frontend.it_g2p", "zipvoice_torch.frontend.ru_g2p",
        "zipvoice_torch.frontend.nl_g2p", "zipvoice_torch.frontend.pl_g2p",
        "zipvoice_torch.frontend.pt_g2p", "zipvoice_torch.frontend.fr_g2p",
        "zipvoice_torch.serving.grpc_server",
        "zipvoice_torch.serving.client_grpc",
        "zipvoice_torch.parallel.sharding_rules",
        "zipvoice_torch.eval.metrics", "zipvoice_torch.eval.cpsim_cli",
        "zipvoice_torch.eval.utmos_model", "zipvoice_torch.eval.utmos_cli",
        "zipvoice_torch.eval.speaker_model", "zipvoice_torch.eval.sim_cli",
        "zipvoice_torch.eval.wer_cli"}
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(worker.FORKSERVER_PRELOAD)
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "modules.json")
        p = ctx.Process(target=worker.import_check, args=(out,))
        p.start()
        p.join(120)
        if p.is_alive():
            p.kill()
        assert p.exitcode == 0, p.exitcode
        with open(out) as f:
            found = json.load(f)
    assert not found["bad"], found["bad"]
    assert need <= set(found["port"]), need - set(found["port"])
    assert len(found["port"]) >= 57
