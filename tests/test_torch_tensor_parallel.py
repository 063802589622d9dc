"""Tensor parallelism in the port
(``zipvoice_torch/parallel/sharding_rules.py``) against the JAX package's
rules and its replicated forward, on the CPU over gloo.

- ``param_spec`` gives every key of the test model the plan that the JAX
  package's ``param_spec`` gives the flax path that
  ``zipvoice_tpu/utils/convert.py::invert_zipvoice`` maps to that key;
- groups of 2, 3 and 4 processes (``torch_parallel_worker.tp_child``,
  forked from the forkserver that tests/test_torch_parallel.py uses), each
  process holding its slice of the weights (``shard_model``), run
  ``forward_fm_decoder`` on tests/test_tensor_parallel.py's model (4
  heads, hidden widths 48, 96, 128 and 160): every rank's output within
  atol 2e-5, rtol 1e-5 of the JAX package's replicated forward (that
  test's tolerances), and the ranks' outputs equal bit for bit.  At 2 and
  4 every module splits (at 4 each rank holds one head, so ranks 1-3 also
  compute head 0 for NonlinAttention); at 3 the attention and the
  feed-forward widths that 3 does not divide stay whole.
"""

import multiprocessing
import os
import threading
import time

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch_parallel_worker as worker
from torch_parity import jax_jit

from zipvoice_torch.models.zipvoice import build_zipvoice
from zipvoice_torch.parallel.sharding_rules import param_spec

TIMEOUT = 300
WORLDS = (2, 3, 4)


def _jax_forward():
    """The JAX package's replicated forward_fm_decoder on the test
    model's weights and inputs, as numpy."""
    from zipvoice_tpu.models.zipvoice import ZipVoice
    from zipvoice_tpu.utils.convert import convert_zipvoice

    params = {"params": convert_zipvoice(worker.tp_state_dict())}
    flax_model = ZipVoice(**worker.TP_CONFIG)
    fwd = jax_jit(lambda p, inputs: flax_model.apply(
        p, **inputs, method="forward_fm_decoder"))
    inputs = {k: jnp.asarray(v) for k, v in worker.tp_inputs().items()}
    return np.asarray(fwd(params, inputs))


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """(the JAX forward, {world: each rank's results}).  Every group forks
    from one forkserver while this process computes the JAX forward; each
    process is joined by one deadline and killed after it."""
    d = tmp_path_factory.mktemp("tp")
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(worker.FORKSERVER_PRELOAD)
    ports = worker.free_ports(len(WORLDS))
    outs = {world: [str(d / f"world{world}-rank{rank}.npz")
                    for rank in range(world)] for world in WORLDS}
    procs = [(ctx.Process(target=worker.tp_child,
                          args=(rank, world, port, outs[world][rank])),
              outs[world][rank])
             for world, port in zip(WORLDS, ports) for rank in range(world)]
    starter = threading.Thread(target=lambda: [p.start() for p, _ in procs],
                               daemon=True)
    deadline = time.monotonic() + TIMEOUT
    starter.start()
    try:
        want = _jax_forward()
        starter.join(max(0.0, deadline - time.monotonic()))
        for p, out in procs:
            p.join(max(0.0, deadline - time.monotonic()))
            err = (open(out + ".err").read() if os.path.exists(out + ".err")
                   else "")
            assert p.exitcode == 0, f"{out}: exit {p.exitcode}\n{err}"
    finally:
        for p, _ in procs:
            if p.pid is not None and p.is_alive():
                p.kill()
    return want, {world: [dict(np.load(o)) for o in outs[world]]
                  for world in WORLDS}


def test_param_spec_matches_jax():
    """Every key of the test model: the port's plan equals the JAX rule's
    spec of its flax path (kernel (None, model) and bias (model,): column;
    kernel (model, None): row; () replicated)."""
    from jax.sharding import PartitionSpec as P

    from zipvoice_tpu.parallel.sharding_rules import param_spec as jax_spec
    from zipvoice_tpu.utils.convert import convert_zipvoice, invert_zipvoice

    plans = {P(None, "model"): "column", P("model"): "column",
             P("model", None): "row", P(): None}
    sd = worker.tp_state_dict()
    params = convert_zipvoice(sd)
    ds = {"fm_decoder": worker.TP_CONFIG["fm_decoder_downsampling_factor"],
          "text_encoder": (1,)}
    seen = set()
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        names = [k.key for k in path]
        one = leaf
        for name in reversed(names):
            one = {name: one}
        (key,) = invert_zipvoice(one, ds)
        want = plans[jax_spec("/".join(names))]
        assert param_spec(key) == want, (key, "/".join(names), want)
        seen.add(key)
    assert seen == set(sd)
    assert {param_spec(k) for k in sd} == {"column", "row", None}


@pytest.mark.parametrize("world", WORLDS)
def test_tp_forward_matches_jax_replicated(tp_runs, world):
    want, runs = tp_runs
    ranks = runs[world]
    whole = sum(p.numel() * p.element_size() for p in build_zipvoice(
        device="cpu", **worker.TP_CONFIG).parameters())
    for rank, r in enumerate(ranks):
        np.testing.assert_allclose(r["out"], want, atol=2e-5, rtol=1e-5,
                                   err_msg=f"world {world} rank {rank}")
        np.testing.assert_array_equal(r["out"], ranks[0]["out"])
        assert int(r["split"]) > 0 and int(r["held"]) < whole
        # the ranks hold one batch: no batch-wide statistic is all-reduced
        assert int(r["reducing"]) == 0
        # 3 divides no head count and two of the fm_decoder's FF widths
        assert (int(r["whole"]) > 0) == (world == 3), (world, r["whole"])
    print(f"world {world}: max |d| "
          f"{np.abs(ranks[0]['out'] - want).max():.3e}; parameter bytes a "
          f"rank {[int(r['held']) for r in ranks]} of {whole}")
