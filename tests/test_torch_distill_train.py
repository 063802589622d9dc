"""Port parity: distillation training (``ZipVoice.sample_intermediate``,
``train/distill.py``) against the JAX package, f32 on the CPU.

The models have one fm_decoder stack of one layer (the JAX side's
lowering of the step dominates).  Each stage's step is held to JAX's
``make_distill_train_step`` on the draws its step makes, fed to the port's
``distill_losses``, with every stochastic gate pinned on both sides as
tests/test_torch_train.py pins them (and the positional-table dropout,
which the scheduled dropout turns on, keeping every element).  JAX's step
is traced unjitted inside a program of the test's own, which also returns
what its models' ``sample_intermediate`` calls gave (the teacher's two
chained solves, the student's one), so the port's are held to them.  Only
the step's losses are read, so its gradient is zeros there
(``jax.value_and_grad`` in that module's namespace returns the value
alone): compiling the student's backward would cost seconds and test
nothing that test_torch_train.py does not.  The losses divide the
difference of two solves by the drawn span t_dest - t, which amplifies
f32 rounding by its inverse, so the losses are compared times span**2,
as the masked mean squares of x1 differences they are; the floor of 1e-9
there covers two solves that nearly coincide (stage second, whose teacher
has the student's weights), where the x1 rounding of about 1e-7 times
their difference is all there is.  Every key of ``KEYS`` is run.  The
three JAX programs compile together (``jax_compile_all``).  Tolerances:
the solves' outputs 1e-5 (they differ by at most 1.5e-6), the losses
times span**2 1e-4 of JAX's plus 1e-9, the EMA update 1e-7, the
partial-trajectory sample 5e-3 (chained CFG)."""

import functools

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from test_torch_train import one_thread, pinned  # noqa: F401
from torch_parity import TINY, jax_compile_all, model_pair, to_jax
from zipvoice_torch.models.zipformer import TrainGenerators
from zipvoice_torch.ops.schedule import adjusted_batch_count
from zipvoice_torch.train.distill import distill_losses, ema_update

CONFIG = dict(TINY, fm_decoder_downsampling_factor=(1,),
              fm_decoder_num_layers=(1,), fm_decoder_cnn_module_kernel=(7,))


def _batch(seed=2):
    """Two rows, the second shorter in tokens and frames (T=24)."""
    rng = np.random.RandomState(seed)
    B, S, T, F = 2, 10, 24, CONFIG["feat_dim"]
    tokens = np.zeros((B, S), np.int32)
    tokens_lens = np.array([9, 6], np.int32)
    for i, n in enumerate(tokens_lens):
        tokens[i, :n] = rng.randint(1, CONFIG["vocab_size"], n)
    return dict(tokens=tokens, tokens_lens=tokens_lens,
                features=rng.randn(B, T, F).astype(np.float32),
                features_lens=np.array([24, 19], np.int32))


def _jax_draws(batch, stage, key):
    """The draws of JAX's distillation step 0 (zipvoice_tpu/train/
    distill.py's split of its key), under the port's ``draws`` names."""
    from zipvoice_tpu.models.conditioning import condition_time_mask

    B, T, F = batch["features"].shape
    rng = jax.random.fold_in(key, 0)
    k_noise, k_t, k_d1, k_d2, k_gs, k_mask = jax.random.split(rng, 9)[:6]
    t = jax.random.uniform(k_t)
    gs = jax.random.uniform(k_gs, (B, 1, 1)) * 2.0
    if stage == "second":
        gs = gs + 1.0
    d1 = jax.random.uniform(k_d1) * jnp.minimum(0.3, 1 - t)
    d2 = jax.random.uniform(k_d2) * jnp.minimum(0.3, 1 - t - d1)
    mask = condition_time_mask(k_mask, jnp.asarray(batch["features_lens"]),
                               T, mask_percent=(0.7, 1.0))
    return dict(noise=jax.random.normal(k_noise, (B, T, F)), t=t, d1=d1,
                d2=d2, guidance_scale=gs, speech_condition_mask=mask)


class _KeepAllDropout:
    """``flax.linen``, but for a ``Dropout`` that keeps every element (and
    rescales): the JAX encoder's positional-table dropout draws its mask
    outside ``_rand_uniform``, which the ``pinned`` fixture pins."""

    def __getattr__(self, name):
        import flax.linen

        return getattr(flax.linen, name)

    @staticmethod
    def Dropout(rate, deterministic=False):
        return lambda x: x / (1.0 - rate)


class _LossOnly:
    """The ``jax`` module, but for a ``value_and_grad`` that returns the
    value and zero gradients, and a ``jit`` that returns the step as it is,
    to be traced inside the test's own program."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def value_and_grad(fn, has_aux=False):
        return lambda p: (fn(p), jax.tree.map(jnp.zeros_like, p))

    @staticmethod
    def jit(fn, **kwargs):
        return fn


STAGES = ("first", "second")
# the keys of every stage's step: the first eight, whose draws put t at
# 0.08-0.99 and the span t_dest - t at 0.0034-0.32
KEYS = range(8)


def _distill_models(stage):
    """(JAX student, its params, port student, JAX teacher, its params,
    port teacher): stage first's teacher is a base model of other weights,
    stage second's the student's own weights."""
    student = model_pair(distill=True, seed=11, config=CONFIG)
    teacher = model_pair(seed=12, config=CONFIG) if stage == "first" \
        else student
    return (*student, *teacher)


def _sample_inputs():
    batch = _batch(seed=4)
    rng = np.random.RandomState(5)
    B, T, F = batch["features"].shape
    mask = np.arange(T)[None, :] >= np.array([[5], [3]])
    return dict(batch, noise=rng.randn(B, T, F).astype(np.float32),
                speech_condition_mask=mask,
                t_start=np.float32(0.3), t_end=np.float32(0.8),
                guidance_scale=np.array([1.5, 0.5], np.float32)[:, None,
                                                                None])


class _Solves:
    """A flax model whose ``apply`` also keeps the first output of each
    call in ``solves``."""

    def __init__(self, model, solves):
        self.model, self.solves = model, solves

    def apply(self, *args, **kwargs):
        out = self.model.apply(*args, **kwargs)
        self.solves.append(out[0])
        return out


def _jax_stage(stage, student, teacher, tx):
    """A function of (state, teacher params, batch, key) that runs JAX's
    distillation step of ``stage`` unjitted and returns its metrics, the
    outputs of its ``sample_intermediate`` calls, in order (the teacher's
    x_mid and target_x1, the student's pred_x1), and its draws."""
    from zipvoice_tpu.train import distill as jax_distill

    def run(state, teacher_params, batch, key):
        solves = []
        step = jax_distill.make_distill_train_step(
            _Solves(student, solves), _Solves(teacher, solves), tx,
            stage=stage)
        _, metrics = step(state, teacher_params, batch, key)
        return metrics, solves, _jax_draws(batch, stage, key)

    return run


@pytest.fixture(scope="module")
def jax_side():
    """The JAX programs and arguments every test here compares with,
    compiled together (``jax_compile_all``): each stage's step on
    ``_batch()``, traced with the gates pinned, called with a key; and
    ``sample_intermediate`` on ``_sample_inputs()``, run."""
    import optax

    import zipvoice_tpu.models.zipformer as jzf
    from zipvoice_tpu.train import distill as jax_distill
    from zipvoice_tpu.train.train_step import init_train_state

    calls = []
    with pytest.MonkeyPatch.context() as mp:
        _pin_jax(mp)
        mp.setattr(jax_distill, "jax", _LossOnly())
        mp.setattr(jzf, "nn", _KeepAllDropout())
        tx = optax.set_to_zero()
        for stage in STAGES:
            jstudent, sparams, _, jteacher, tparams, _ = _distill_models(
                stage)
            calls.append((_jax_stage(stage, jstudent, jteacher, tx), (
                init_train_state(sparams["params"], tx), tparams["params"],
                to_jax(_batch()), jax.random.PRNGKey(0))))
        jmodel, params, _ = model_pair(seed=13, config=CONFIG)
        calls.append((lambda p, x: jmodel.apply(
            p, **x, num_step=2, method="sample_intermediate"),
            (params, to_jax(_sample_inputs()))))
        programs = jax_compile_all(calls)
    steps = {stage: (program, args[:3])
             for stage, program, (_, args) in zip(STAGES, programs, calls)}
    sample = jax.tree.map(np.asarray, programs[-1](*calls[-1][1]))
    return steps, sample


def _pin_jax(mp):
    """The JAX half of tests/test_torch_train.py's ``pinned``."""
    import zipvoice_tpu.models.zipformer as jzf

    mp.setattr(jzf, "_rand_uniform", lambda rng, shape: (
        jnp.zeros(shape) if shape == () else jnp.full(shape, 0.97)))
    mp.setattr(jzf, "_stochastic", lambda m, p, fn, x: fn(x))
    mp.setattr(jzf, "balancer", lambda x, *a, **k: x)


@functools.cache
def _port_models(stage):
    """(port student, port teacher in eval mode, the list that their
    ``sample_intermediate`` calls append their first outputs to), built
    once a stage."""
    _, _, student, _, _, teacher = _distill_models(stage)
    solves = []
    for model in {id(m): m for m in (student, teacher)}.values():
        inner = model.sample_intermediate

        def sample_intermediate(inner=inner, **kwargs):
            out = inner(**kwargs)
            solves.append(out[0].detach())
            return out

        model.sample_intermediate = sample_intermediate
    teacher.eval()
    return student, teacher, solves


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("stage", STAGES)
def test_distill_losses_match_jax(pinned, jax_side, stage, key):
    """One step's solves and losses: stage first with a base teacher of
    other weights through CFG, stage second with the student's own weights
    as the EMA teacher (distill input); the student in train mode with the
    schedule clock at 100000.  The teacher's x_mid and target_x1 and the
    student's pred_x1 within 1e-5 of JAX's, and loss and ref_loss times
    span**2 within 1e-4 of JAX's plus 1e-9."""
    program, args = jax_side[0][stage]
    metrics, want_solves, draws = program(*args, jax.random.PRNGKey(key))
    student, teacher, solves = _port_models(stage)
    solves.clear()
    batch = _batch()
    tbatch = {k: torch.from_numpy(v).long() if v.dtype == np.int32
              else torch.from_numpy(v) for k, v in batch.items()}
    draws = {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}
    loss, ref = distill_losses(
        student, teacher, tbatch, draws, stage,
        dict(train=True, dropout_rate=None, gens=TrainGenerators(0),
             batch_count=adjusted_batch_count(0, max_duration=250.0,
                                              finetune=True)))
    assert len(solves) == len(want_solves) == 3
    for name, got, want in zip(("x_mid", "target_x1", "pred_x1"), solves,
                               want_solves):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=name)
    span2 = float(draws["d1"] + draws["d2"]) ** 2
    for got, want in ((loss, metrics["loss"]), (ref, metrics["ref_loss"])):
        np.testing.assert_allclose(got.item() * span2, float(want) * span2,
                                   rtol=1e-4, atol=1e-9)


def test_ema_update_matches_jax():
    """``ema_update`` (functional and in place) against JAX's on the same
    tensors, within 1e-7."""
    from zipvoice_tpu.train.distill import ema_update as jax_ema

    rng = np.random.RandomState(3)
    ema = {k: rng.randn(*s).astype(np.float32)
           for k, s in (("w", (6, 5)), ("b", (5,)))}
    new = {k: rng.randn(*v.shape).astype(np.float32) for k, v in ema.items()}
    want = jax_ema(ema, new, 0.99)
    tema = {k: torch.from_numpy(v.copy()) for k, v in ema.items()}
    tnew = {k: torch.from_numpy(v) for k, v in new.items()}
    got = ema_update(tema, tnew, 0.99)
    same = ema_update(tema, tnew, 0.99, inplace=True)
    for k in ema:
        for g in (got[k], same[k], tema[k]):
            np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-7)
    assert same["w"] is tema["w"]


def test_sample_intermediate_matches_jax(jax_side):
    """``sample_intermediate`` of the base model over a span whose bounds
    are tensors (as distillation draws them), two Euler steps with CFG at
    per-row guidance scales, within 5e-3 of JAX's."""
    _, _, model = model_pair(seed=13, config=CONFIG)
    want, want_pm = jax_side[1]
    with torch.no_grad():
        got, pm = model.sample_intermediate(
            **{k: torch.from_numpy(np.asarray(v)).long()
               if np.asarray(v).dtype == np.int32
               else torch.from_numpy(np.asarray(v))
               for k, v in _sample_inputs().items()}, num_step=2)
    np.testing.assert_array_equal(pm.numpy(), want_pm)
    valid = ~want_pm
    np.testing.assert_allclose(got.numpy()[valid], want[valid], atol=5e-3,
                               rtol=0)
