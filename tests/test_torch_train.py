"""Port parity of the training path (zipvoice_torch) vs the JAX package, f32
on CPU: one Zipformer layer's gradients in train mode, the model's training
loss, ScaledAdam with Eden on the model's parameter tree, and a CPU run of
the train step.  The whole model's gradients are held in the ``slow`` test.

Every stochastic gate is pinned on both sides as tests/test_schedules.py
pins the JAX package's: scalar coins read 0 (const-attention on, each
regularizer applied), keep-masks read 0.97 (every sequence kept), dropout
is off and the balancers are identities (their per-channel violation test
is a knife edge under float noise; their gradients are held op by op in
test_torch_train_ops.py).  The gate of the attention kernels is lowered so
that the port's trainable pair (its plain versions here) runs where JAX
takes its plain skew path.
"""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from torch_parity import DS, TINY, jax_jit, jax_pos_encoding, model_pair
from zipvoice_torch.models.zipformer import TrainGenerators
from zipvoice_torch.train.optim import ScaledAdam, eden_schedule
from zipvoice_torch.train.train_step import make_eval_step, make_train_step
from zipvoice_torch.utils.convert import zipformer_state_dict

# pos-emb skip off (its schedule is 0 past 4000), const-attention on
BATCH_COUNT = 5000.0

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture
def pinned(monkeypatch):
    """Pin the coins, masks and balancers of both packages; lower the
    port's kernel gate below the test lengths."""
    import zipvoice_torch.models.zipformer as tzf
    import zipvoice_tpu.models.zipformer as jzf

    monkeypatch.setattr(jzf, "_rand_uniform", lambda rng, shape: (
        jnp.zeros(shape) if shape == () else jnp.full(shape, 0.97)
    ))
    monkeypatch.setattr(jzf, "_stochastic", lambda m, p, fn, x: fn(x))
    monkeypatch.setattr(jzf, "balancer", lambda x, *a, **k: x)
    monkeypatch.setattr(tzf, "_rand_uniform", lambda g, shape, device=None: (
        0.0 if tuple(shape) == () else torch.full(shape, 0.97, device=device)
    ))
    monkeypatch.setattr(tzf, "_stochastic", lambda g, p, fn, x: fn(x))
    monkeypatch.setattr(tzf, "balancer", lambda x, *a, **k: x)
    monkeypatch.setattr(tzf, "MIN_SEQ_LEN", 20)


@pytest.fixture
def one_thread():
    """One intra-op thread for small CPU work beside JAX's thread pool
    (which otherwise slows these bf16 steps tenfold); restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_RNGS = {"dropout": jax.random.PRNGKey(1), "reg": jax.random.PRNGKey(2),
         "skip": jax.random.PRNGKey(3)}


def _assert_grads_close(got, want, rel, what):
    bound = rel * max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max|d| {err:.3e} > {bound:.3e}"


def test_layer_train_grads_match_jax(pinned):
    """One fm_decoder ZipformerEncoderLayer (dim 48, T=27, a padded row)
    with train=True and a batch count: the gradient of every parameter and
    of the input within 2e-4 of the tensor's largest |grad|."""
    from zipvoice_tpu.models.zipformer import ZipformerEncoderLayer as JaxLayer
    from zipvoice_tpu.ops.schedule import layerdrop_schedule

    _, params, tmodel = model_pair(seed=4)
    jparams = params["params"]["fm_decoder"]["encoders_0"]["encoder"][
        "layers_0"]
    tlayer = tmodel.fm_decoder.encoders[0].layers[0]
    D = TINY["fm_decoder_dim"]
    jlayer = JaxLayer(
        embed_dim=D, pos_dim=TINY["pos_dim"],
        num_heads=TINY["fm_decoder_num_heads"],
        query_head_dim=TINY["query_head_dim"],
        pos_head_dim=TINY["pos_head_dim"],
        value_head_dim=TINY["value_head_dim"],
        feedforward_dim=TINY["fm_decoder_feedforward_dim"],
        cnn_module_kernel=TINY["fm_decoder_cnn_module_kernel"][0],
        bypass_skip_rate=layerdrop_schedule(
            4000 / 6, 8000 / 6, 1, 0, final_layerdrop_rate=0.035
        ),
    )
    rng = np.random.RandomState(5)
    B, T = 2, 27
    src = rng.randn(B, T, D).astype(np.float32)
    time_emb = (0.5 * rng.randn(B, 1, D)).astype(np.float32)
    mask = np.arange(T)[None, :] >= np.array([[T], [19]])
    cot = rng.randn(B, T, D).astype(np.float32)
    pos = jax_pos_encoding(T, TINY["pos_dim"])

    def loss(p, x):
        out = jlayer.apply({"params": p}, x, pos, jnp.asarray(time_emb),
                           jnp.asarray(mask), train=True, dropout_rate=0.0,
                           batch_count=BATCH_COUNT, rngs=_RNGS)
        return jnp.sum(out * cot)

    jg_params, jg_src = jax_jit(jax.grad(loss, argnums=(0, 1)))(
        jparams, jnp.asarray(src)
    )

    x = torch.from_numpy(src).requires_grad_(True)
    out = tlayer(x, torch.from_numpy(np.array(pos)),
                 torch.from_numpy(time_emb), torch.from_numpy(mask),
                 train=True, dropout_rate=0.0, batch_count=BATCH_COUNT,
                 gens=TrainGenerators(0))
    (out * torch.from_numpy(cot)).sum().backward()
    _assert_grads_close(x.grad.numpy(), np.asarray(jg_src), 2e-4, "input")
    want = zipformer_state_dict(jax.tree.map(np.asarray, jg_params))
    got = dict(tlayer.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        _assert_grads_close(got[name].grad.numpy(), w.numpy(), 2e-4, name)


def _loss_inputs(seed=6):
    rng = np.random.RandomState(seed)
    B, S, T, F = 2, 12, 27, TINY["feat_dim"]
    tokens = np.zeros((B, S), np.int64)
    tokens_lens = np.array([10, 7])
    for i, n in enumerate(tokens_lens):
        tokens[i, :n] = rng.randint(1, TINY["vocab_size"], n)
    features_lens = np.array([27, 20])
    scm = ((np.arange(T)[None, :] >= np.array([[6], [4]]))
           & (np.arange(T)[None, :] < np.array([[24], [17]])))
    return dict(
        tokens=tokens, tokens_lens=tokens_lens,
        features=rng.randn(B, T, F).astype(np.float32),
        features_lens=features_lens,
        noise=rng.randn(B, T, F).astype(np.float32),
        t=rng.rand(B, 1, 1).astype(np.float32),
        condition_drop_mask=np.array([False, True]),
        speech_condition_mask=scm,
    )


def _jax_loss(jmodel):
    def loss(p, inputs):
        return jmodel.apply({"params": p}, **inputs, train=True,
                            dropout_rate=0.0, batch_count=BATCH_COUNT,
                            rngs=_RNGS)
    return loss


def _port_loss(tmodel, x):
    return tmodel(**{k: torch.from_numpy(v) for k, v in x.items()},
                  gens=TrainGenerators(0), train=True, dropout_rate=0.0,
                  batch_count=BATCH_COUNT)


def test_train_loss_matches_jax(pinned):
    """The flow-matching training loss of the tiny model, train=True with a
    batch count, T=27 (the top level takes the trainable pair)."""
    jmodel, params, tmodel = model_pair(seed=5)
    x = _loss_inputs()
    want = jax_jit(_jax_loss(jmodel))(
        params["params"], {k: jnp.asarray(v) for k, v in x.items()}
    )
    got = _port_loss(tmodel, x)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=0)


@pytest.mark.slow
def test_train_grads_match_jax(pinned):
    """The whole model's parameter gradients of the training loss, each
    within 2e-4 of its tensor's largest |grad| (about 45 s of JAX compile
    on a CPU, so outside the tier-1 run)."""
    jmodel, params, tmodel = model_pair(seed=5)
    x = _loss_inputs()
    jgrads = jax_jit(jax.grad(_jax_loss(jmodel)))(
        params["params"], {k: jnp.asarray(v) for k, v in x.items()}
    )
    _port_loss(tmodel, x).backward()
    want = _port_layout(jax.tree.map(np.asarray, jgrads))
    got = dict(tmodel.named_parameters())
    assert set(want) == set(got)
    for name, w in want.items():
        g = got[name].grad
        g = np.zeros_like(w.numpy()) if g is None else g.numpy()
        _assert_grads_close(g, w.numpy(), 2e-4, name)


def _port_layout(tree):
    """A flax ZipVoice param (or grad) tree, or part of one, in the port's
    state_dict layout."""
    out = {}
    if "embed" in tree:
        out["embed.weight"] = torch.from_numpy(
            np.array(tree["embed"]["embedding"], np.float32))
    for name in ("fm_decoder", "text_encoder"):
        if name in tree:
            out.update(zipformer_state_dict(tree[name], name + ".", DS[name]))
    return out


# The JAX step takes ~5 s to lower and compile per 50 tensors: tier 1 runs
# a slice of the tree that holds every layout the converter changes (dense
# kernels and biases, a depthwise filter, BiasNorm's scalar, the embedding),
# the slow run the whole tree.
_SLICE = ("self_attn_weights", "conv_module1", "norm", "bypass")


def _tree_part(params, part):
    if part == "whole":
        return params
    layer = params["text_encoder"]["encoders_0"]["encoder"]["layers_0"]
    return {"embed": params["embed"], "text_encoder": {"encoders_0": {
        "encoder": {"layers_0": {k: layer[k] for k in _SLICE}}}}}


@pytest.mark.parametrize("part", [
    "slice", pytest.param("whole", marks=pytest.mark.slow),
])
def test_scaled_adam_matches_optax_on_model_tree(part):
    """ScaledAdam + Eden against the JAX package's optax version on the tiny
    model's parameter tree (the port's layouts on one side, flax's on the
    other), with clipping on: nine steps cross the size and clipping
    periods (4), and a 10x gradient at step 6 is clipped."""
    import optax

    from zipvoice_tpu.train.optim import eden_schedule as jax_eden
    from zipvoice_tpu.train.optim import scaled_adam

    _, params, tmodel = model_pair(seed=7)
    tree = _tree_part(params["params"], part)
    named = dict(tmodel.named_parameters())
    named = {k: named[k] for k in _port_layout(tree)}
    kw = dict(clipping_scale=2.0, size_update_period=4,
              clipping_update_period=4)
    tx = scaled_adam(lr=jax_eden(base_lr=0.02, warmup_batches=5), **kw)
    opt = ScaledAdam(named.values(),
                     lr=eden_schedule(base_lr=0.02, warmup_batches=5), **kw)
    leaves, treedef = jax.tree.flatten(tree)
    rng = np.random.RandomState(0)

    def jax_step(p, state, g):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    step = jax_jit(jax_step)
    state = jax_jit(tx.init)(tree)
    for s in range(9):
        scale = 10.0 if s == 6 else 1.0
        g = jax.tree.unflatten(treedef, [
            np.asarray(scale * 0.1 * rng.randn(*np.shape(v)), np.float32)
            for v in leaves
        ])
        tree, state = step(tree, state, g)
        for name, v in _port_layout(g).items():
            named[name].grad = v
        opt.step()
    want = _port_layout(jax.tree.map(np.asarray, tree))
    assert len(want) == len(named) >= 12
    for name, w in want.items():
        np.testing.assert_allclose(named[name].detach().numpy(), w.numpy(),
                                   atol=2e-6, rtol=2e-5, err_msg=name)


def test_scaled_adam_ignores_layout():
    """The port's ScaledAdam moves a weight and its transpose (and a
    depthwise filter as (k, C) and as (C, 1, k)) identically: its RMS,
    sums and element-wise rules do not see the layout the converter
    changes, which is what lets the tree comparison above hold."""
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.randn(6, 10).astype(np.float32))
    f = torch.from_numpy(rng.randn(7, 5).astype(np.float32))
    p1 = [torch.nn.Parameter(a.clone()), torch.nn.Parameter(f.clone())]
    p2 = [torch.nn.Parameter(a.T.clone()),
          torch.nn.Parameter(f.T[:, None, :].clone())]
    o1 = ScaledAdam(p1, lr=0.05, clipping_scale=2.0)
    o2 = ScaledAdam(p2, lr=0.05, clipping_scale=2.0)
    for _ in range(6):
        ga = torch.from_numpy(rng.randn(6, 10).astype(np.float32))
        gf = torch.from_numpy(rng.randn(7, 5).astype(np.float32))
        p1[0].grad, p1[1].grad = ga, gf
        p2[0].grad, p2[1].grad = ga.T.clone(), gf.T[:, None, :].clone()
        o1.step()
        o2.step()
    torch.testing.assert_close(p2[0].detach().T, p1[0].detach(), rtol=0,
                               atol=1e-7)
    torch.testing.assert_close(p2[1].detach()[:, 0, :].T, p1[1].detach(),
                               rtol=0, atol=1e-7)


def test_train_step_runs_on_cpu(monkeypatch):
    """Two steps of make_train_step on the tiny model with the schedules
    and scheduled dropout on, bf16 compute and f32 parameters: finite
    metrics, moved parameters, the trainable pair at the top level; then
    make_eval_step's loss."""
    import zipvoice_torch.models.zipformer as tzf
    from zipvoice_torch.kernels import rel_pos_attention as kernels
    from zipvoice_torch.models.zipvoice import build_zipvoice

    monkeypatch.setattr(tzf, "MIN_SEQ_LEN", 20)
    model = build_zipvoice(device="cpu", dtype=torch.bfloat16, train=True,
                           **TINY)
    opt = ScaledAdam(model.parameters(), lr=eden_schedule(base_lr=0.02),
                     clipping_scale=2.0)
    step = make_train_step(model, opt, dropout_rate=None, schedules=True,
                           max_duration=250.0, seed=3)
    rng = np.random.RandomState(0)
    B, S, T = 2, 12, 24
    batch = dict(
        tokens=torch.from_numpy(rng.randint(1, TINY["vocab_size"], (B, S))),
        tokens_lens=torch.tensor([11, 8]),
        features=torch.from_numpy(
            rng.randn(B, T, TINY["feat_dim"]).astype(np.float32)),
        features_lens=torch.tensor([24, 19]),
    )
    before = [p.detach().clone() for p in model.parameters()]
    calls = kernels.rel_pos_attention_weights_train.launches
    for _ in range(2):
        metrics = step(batch)
        assert all(np.isfinite(float(v)) for v in metrics.values())
    assert step.step == 2 and opt.step_count == 2
    assert all(p.dtype == torch.float32 for p in model.parameters())
    moved = max(float((p.detach() - b).abs().max())
                for p, b in zip(model.parameters(), before))
    assert moved > 0
    # CPU tensors take the plain versions: the kernel counters stay put
    assert kernels.rel_pos_attention_weights_train.launches == calls
    # the validation loss draws the same noise and span for every call
    eval_step = make_eval_step(model, seed=4)
    losses = [float(eval_step(batch)) for _ in range(2)]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
