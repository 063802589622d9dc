"""Port parity: the pipeline's batch path (zipvoice_torch) vs the JAX
``InferencePipeline`` with the same seed."""

import numpy as np
import pytest

import conftest  # noqa: F401

import torch

from torch_parity import TINY, TINY_VOCOS, fast_pipeline, model_pair
from torch_parity import one_torch_thread  # noqa: F401
from zipvoice_torch.infer.pipeline import InferencePipeline
from zipvoice_torch.vocoder.vocos import Vocos

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_sample_batch_matches_jax_pipeline():
    """Three rows with their own prompts and speeds, padded to a batch of
    4 at the smallest buckets (S=32, T=128); both pipelines draw the noise
    from RandomState(5)."""
    from zipvoice_tpu.infer.pipeline import InferencePipeline as JaxPipeline

    jmodel, params, tmodel = model_pair(seed=2)
    tvocos = Vocos(**TINY_VOCOS).eval()
    jpipe = fast_pipeline(JaxPipeline(jmodel, params, None, None, None,
                                      seed=5))
    tpipe = InferencePipeline(tmodel, tvocos, seed=5, device="cpu")

    rng = np.random.RandomState(0)
    V, F = TINY["vocab_size"], TINY["feat_dim"]
    texts = [list(rng.randint(1, V, n)) for n in (15, 9, 12)]
    prompts = [list(rng.randint(1, V, n)) for n in (8, 6, 10)]
    prompt_feats = [(0.5 * rng.randn(n, F)).astype(np.float32)
                    for n in (30, 22, 41)]
    kw = dict(num_step=2, guidance_scale=1.0, speed=[1.0, 0.9, 1.2],
              t_shift=0.5)
    jf, jl = jpipe._sample_batch(texts, prompts, prompt_feats, **kw)
    tf, tl = tpipe._sample_batch(texts, prompts, prompt_feats, **kw)
    assert tpipe._seen_buckets == {(4, 32, 128)}
    np.testing.assert_array_equal(tl, jl)
    for i, n in enumerate(jl):
        # features carry the 1/feat_scale = 10x gain of the pipeline
        np.testing.assert_allclose(tf[i, :n], jf[i, :n], atol=5e-2, rtol=0)

    # vocoding: one padded (4, 128) batch, each wav trimmed to its frames
    wavs = tpipe._vocode_chunks([tf[i, :n] for i, n in enumerate(tl)])
    mel = torch.zeros(4, 128, F)
    for i, n in enumerate(tl):
        mel[i, :n] = torch.from_numpy(tf[i, :n])
    with torch.no_grad():
        full = torch.clamp(tvocos(mel), -1.0, 1.0).numpy()
    for i, (w, n) in enumerate(zip(wavs, tl)):
        np.testing.assert_array_equal(w, full[i, : n * 256])



def test_warm_bucket_snaps_to_the_ladder():
    """An off-ladder warm-up runs at the bucket real traffic would take."""
    _, _, tmodel = model_pair(seed=3)
    pipe = InferencePipeline(tmodel, Vocos(**TINY_VOCOS), device="cpu")
    pipe.warm_bucket(3, 20, 100, num_step=1, guidance_scale=1.0)
    assert pipe._seen_buckets == {(4, 32, 128)}
