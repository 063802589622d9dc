"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

A tiny ZipVoice whose weights come from a seed is expressed as JAX-package
params (through the JAX package's own checkpoint converter) and carried back
into the port with ``state_dict_from_jax_params`` and a strict load, so both
sides run the same weights.  JAX programs are jitted: eager flax spends
seconds per call compiling op by op on the CPU.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from zipvoice_torch.models.zipformer import set_kernel_config
from zipvoice_torch.models.zipvoice import build_zipvoice
from zipvoice_torch.utils.convert import state_dict_from_jax_params


def _one_torch_thread():
    """One torch intra-op thread: the port's small CPU programs beside JAX's
    own thread pool run faster so than on torch's default pool (bf16 steps
    tenfold); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# for a module's tests and fixtures, and for one test
one_torch_thread = pytest.fixture(scope="module")(_one_torch_thread)
one_thread = pytest.fixture(_one_torch_thread)


TINY = dict(
    fm_decoder_downsampling_factor=(1, 2, 4, 2, 1),
    fm_decoder_num_layers=(1, 1, 1, 1, 1),
    fm_decoder_cnn_module_kernel=(7, 5, 3, 5, 7),
    fm_decoder_feedforward_dim=64,
    fm_decoder_num_heads=4,
    fm_decoder_dim=48,
    text_encoder_num_layers=1,
    text_encoder_feedforward_dim=48,
    text_encoder_cnn_module_kernel=5,
    text_encoder_num_heads=4,
    text_encoder_dim=32,
    time_embed_dim=32,
    text_embed_dim=32,
    query_head_dim=8,
    value_head_dim=12,
    pos_head_dim=4,
    pos_dim=48,
    feat_dim=20,
    vocab_size=30,
    pad_id=0,
)
DS = {"fm_decoder": (1, 2, 4, 2, 1), "text_encoder": (1,)}
TINY_VOCOS = dict(n_mels=TINY["feat_dim"], dim=32, intermediate_dim=48,
                  num_layers=2, n_fft=1024, hop_length=256)


def model_pair(distill=False, seed=0, config=TINY):
    """(flax model, flax params, port model) with the same weights.  Every
    weight is perturbed from its init so that no init constant (zero
    biases, 0.5 bypass scales) hides a wiring fault."""
    from zipvoice_tpu.models.zipvoice import ZipVoice, ZipVoiceDistill
    from zipvoice_tpu.utils.convert import convert_zipvoice

    rng = np.random.RandomState(seed)
    source = build_zipvoice(distill=distill, device="cpu", seed=seed,
                            **config)
    ref_sd = {
        k: v.numpy()
        + np.float32(0.05) * np.asarray(rng.randn(*v.shape), np.float32)
        for k, v in source.state_dict().items()
    }
    params = {"params": convert_zipvoice(ref_sd)}
    port = build_zipvoice(distill=distill, device="cpu", **config)
    port.load_state_dict(
        state_dict_from_jax_params(params["params"], DS), strict=True
    )
    flax_model = (ZipVoiceDistill if distill else ZipVoice)(**config)
    return flax_model, params, port


# XLA's backend optimizations cost more compile time than these tiny
# programs run for
_FAST_COMPILE = {"xla_backend_optimization_level": 0,
                 "xla_llvm_disable_expensive_passes": True}


def jax_jit(fn):
    """``jax.jit(fn)``, compiled with XLA's backend optimizations off, once
    per signature of its arguments."""
    jitted = jax.jit(fn)
    compiled = {}

    def run(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (tree, tuple((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(_FAST_COMPILE)
        return compiled[key](*args)

    return run


@functools.cache
def jax_pos_encoding(T, pos_dim):
    """The JAX package's ``compact_rel_pos_encoding(T, pos_dim)``, as numpy,
    from one compiled program (run eagerly, each of its ops would compile
    on its own)."""
    from zipvoice_tpu.models.zipformer import compact_rel_pos_encoding

    return np.asarray(
        jax_jit(lambda: compact_rel_pos_encoding(T, pos_dim))())


def jax_compile_all(calls):
    """Each ``(fn, args)`` of ``calls`` lowered in turn (tracing holds the
    interpreter lock) and then compiled all at once on threads (XLA's
    compiler does not hold it), with XLA's backend optimizations off: the
    compiled programs, in order, each to be called with its ``args``."""
    from concurrent.futures import ThreadPoolExecutor

    lowered = [jax.jit(fn).lower(*args) for fn, args in calls]
    with ThreadPoolExecutor(len(lowered)) as pool:
        return list(pool.map(lambda low: low.compile(_FAST_COMPILE),
                             lowered))


def assert_params_like_init(params, init, *args):
    """``params`` holds the leaves, by path and shape, of the tree that
    ``init(PRNGKey(0), *args)`` makes, traced abstractly and not run: the
    converter that made ``params`` neither dropped nor invented one."""
    def leaves(tree):
        return {jax.tree_util.keystr(path): tuple(np.shape(v))
                for path, v in jax.tree_util.tree_leaves_with_path(tree)}

    want = leaves(jax.eval_shape(init, jax.random.PRNGKey(0), *args))
    got = leaves(params)
    assert got == want, (sorted(set(got) ^ set(want)),
                         {k: (got[k], want[k]) for k in set(got) & set(want)
                          if got[k] != want[k]})


def fast_pipeline(jpipe):
    """A JAX ``InferencePipeline`` whose sample and vocoder programs are
    compiled with XLA's backend optimizations off (``jax_jit``): they cost
    more compile time than these tiny programs run for."""
    sample_fn, vocode_fn, cache = jpipe._sample_fn, jpipe._vocode_fn, {}

    def fast_sample(*key):
        if key not in cache:
            cache[key] = jax_jit(sample_fn(*key))
        return cache[key]

    vocode = jax_jit(vocode_fn())
    jpipe._sample_fn = fast_sample
    jpipe._vocode_fn = lambda: vocode
    return jpipe


def jax_method(flax_model, method, **static):
    """A jitted ``flax_model.apply(params, **inputs, method=method)``."""
    return jax_jit(lambda params, inputs: flax_model.apply(
        params, **inputs, **static, method=method
    ))


def to_jax(arrays):
    return {k: jnp.asarray(v) for k, v in arrays.items()}


def to_torch(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def sample_inputs(feat_dim=TINY["feat_dim"], vocab=TINY["vocab_size"],
                  seed=3):
    """Two rows: the second has a shorter prompt, text and output, so the
    padding masks, the downsampling fix-up and strip_prompt all engage.
    27 frames is no multiple of the largest downsampling factor."""
    rng = np.random.RandomState(seed)
    tokens = np.zeros((2, 16), np.int64)
    tokens_lens = np.array([14, 9])
    for i, n in enumerate(tokens_lens):
        tokens[i, :n] = rng.randint(1, vocab, n)
    T = 27
    prompt_features_lens = np.array([6, 4])
    prompt_features = np.zeros((2, T, feat_dim), np.float32)
    for i, n in enumerate(prompt_features_lens):
        prompt_features[i, :n] = rng.randn(n, feat_dim)
    return dict(
        tokens=tokens,
        tokens_lens=tokens_lens,
        prompt_tokens_lens=np.array([4, 3]),
        prompt_features=prompt_features,
        prompt_features_lens=prompt_features_lens,
        features_lens=np.array([23, 17]),
        noise=rng.randn(2, T, feat_dim).astype(np.float32),
    )


SAMPLE_KW = dict(num_step=3, t_shift=0.5)


@functools.cache
def _jax_sample(distill, guidance_scale):
    """The JAX package's ``sample`` on ``sample_inputs`` with
    ``model_pair(distill, seed=int(distill))``'s weights, as numpy (x1,
    padding mask): computed once a process, since
    test_torch_zipvoice.py and test_torch_fused_attention.py hold the port
    to the same one, and each compile costs seconds."""
    jmodel, params, _ = model_pair(distill=distill, seed=int(distill))
    x1, pm = jax_method(jmodel, "sample", guidance_scale=guidance_scale,
                        **SAMPLE_KW)(params, to_jax(sample_inputs()))
    return np.asarray(x1), np.asarray(pm)


def assert_sample_matches(distill, guidance_scale, kernel_config=False):
    """``ZipVoice.sample`` of the port (in the kernel configuration with
    ``kernel_config``) vs the JAX package's on ``sample_inputs``: the same
    padding mask, features within 5e-3."""
    _, _, tmodel = model_pair(distill=distill, seed=int(distill))
    set_kernel_config(tmodel, kernel_config)
    x1_j, pm_j = _jax_sample(distill, guidance_scale)
    x1_t, pm_t = tmodel.sample(**to_torch(sample_inputs()),
                               guidance_scale=guidance_scale, **SAMPLE_KW)
    np.testing.assert_array_equal(pm_t.numpy(), pm_j)
    valid = ~pm_j
    np.testing.assert_allclose(x1_t.numpy()[valid], x1_j[valid], atol=5e-3,
                               rtol=0)
