"""Multi-process training in the port (``zipvoice_torch/parallel/mesh.py``,
the trainer's multi-process flags, the dataset's per-host rows), on the
CPU over gloo.

The rule under test is the JAX package's: N processes compute what one
process computes on the same global batch (tests/test_multiprocess_train.py
holds two JAX processes to one within atol 1e-5, rtol 1e-4 after 4 steps).
Six pairs of ranks (``torch_parallel_worker.py``, forked from one
forkserver, each process joined by a deadline and killed after it) run
beside each other, four a step scenario each, two the trainer CLI, while
this process computes the one-process runs of the same scenarios; the
cases read the results:

- (a) JAX's settings (lr 0.03, schedules on, no dropout, no condition drop,
  max_duration 50), (b) dropout 0.1 and condition drop 0.2, (c) the same
  with rows 2-3 all padding, so that rank 1 holds no frame of the loss,
  (e) the distillation step (stage first, lr 0.03): the pair's parameters
  after 4 steps within atol 1e-5, rtol 1e-4 of one process's, its losses
  within 1e-5 relative, and both ranks' parameters equal bit for bit.
  The elements whose one-process gradient is zero up to rounding (not
  zero, at most 1e-6 of their leaf's largest: the key projection's bias,
  to which softmax is blind) move with that rounding, so they are held to
  the bit-equality of the ranks alone; they are at most 1% of the
  elements (``torch_parallel_worker.check_against_one_process``);
- (d) the trainer CLI on two ranks with ``--per-host-data on`` and
  ``off``: each rank's batches and the written ``epoch-1`` equal bit for
  bit.

The one-process side is held to JAX by tests/test_torch_train.py and
tests/test_torch_distill_train.py.  ``local_batch_rows`` is held to the
JAX package's on the conftest's virtual CPU mesh.
"""

import json
import multiprocessing
import os
import string
import threading
import time

import numpy as np
import pytest

import conftest  # noqa: F401

import torch
import torch_parallel_worker as worker

from zipvoice_torch.parallel import mesh

TIMEOUT = 300


def _corpus(d):
    """prepare_dataset and compute_fbank on eight 1.3 s tones, the CLI
    model's config and a character token file, in ``d``."""
    from test_train_cli import TINY_CFG

    from zipvoice_torch.bin import compute_fbank, prepare_dataset
    from zipvoice_torch.frontend.audio import save_wav

    sr = 24000
    rows = []
    for i in range(8):
        n = int(1.3 * sr)
        wav = (0.2 * np.sin(2 * np.pi * (200 + 30 * i) * np.arange(n) / sr)
               ).astype(np.float32)[None]
        save_wav(str(d / f"u{i}.wav"), wav, sr)
        rows.append(f"u{i}\thello world number {i}.\t{d / f'u{i}.wav'}")
    (d / "train.tsv").write_text("\n".join(rows) + "\n")
    chars = ["_"] + list(string.ascii_lowercase) + list(" .,!?0123456789")
    (d / "tokens.txt").write_text(
        "".join(f"{c}\t{i}\n" for i, c in enumerate(chars)))
    manifest = prepare_dataset.main([
        "--tsv-path", str(d / "train.tsv"), "--prefix", "toy", "--subset",
        "train", "--output-dir", str(d)])
    assert os.path.basename(manifest) == worker.MANIFEST
    compute_fbank.main(["--manifest", manifest, "--output-dir",
                        str(d / "fbank"), "--num-jobs", "2"])
    (d / "model.json").write_text(json.dumps({"model": TINY_CFG}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the one-process results, rank 0's, rank 1's); a rank's results
    hold its scenarios' and its CLI runs'.  Every pair of
    ``worker.jobs()`` forks from one forkserver, which imports torch and
    the port once, while this process runs the scenarios alone; each
    process is joined by one deadline and killed after it."""
    d = tmp_path_factory.mktemp("parallel")
    _corpus(d)
    jobs = worker.jobs()
    ports = worker.free_ports(len(jobs))
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload(worker.FORKSERVER_PRELOAD)
    outs = [[str(d / f"job{i}-rank{rank}.npz") for rank in range(2)]
            for i in range(len(jobs))]
    procs = [ctx.Process(target=worker.child, args=(
        job, rank, 2, port, outs[i][rank], str(d)))
        for i, (job, port) in enumerate(zip(jobs, ports))
        for rank in range(2)]
    # a start waits until the forkserver has imported its modules
    starter = threading.Thread(target=lambda: [p.start() for p in procs],
                               daemon=True)
    deadline = time.monotonic() + TIMEOUT
    starter.start()
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            solo = worker.run_scenarios(0, 1)
        finally:
            torch.set_num_threads(threads)
        starter.join(max(0.0, deadline - time.monotonic()))
        for p, out in zip(procs, sum(outs, [])):
            p.join(max(0.0, deadline - time.monotonic()))
            err = (open(out + ".err").read() if os.path.exists(out + ".err")
                   else "")
            assert p.exitcode == 0, f"{out}: exit {p.exitcode}\n{err}"
    finally:
        for p in procs:
            if p.pid is not None and p.is_alive():
                p.kill()
    ranks = [{k: v for i in range(len(jobs))
              for k, v in np.load(outs[i][rank]).items()}
             for rank in range(2)]
    return solo, *ranks


@pytest.mark.parametrize("scenario", list(worker.SCENARIOS))
def test_two_ranks_match_one_process(runs, scenario):
    worst, skipped, total = worker.check_against_one_process(*runs,
                                                             scenario)
    print(f"{scenario}: {worst:.3f} of the bound at most; {skipped} of "
          f"{total} elements with a gradient zero up to rounding")


def test_per_host_data_on_and_off_agree(runs):
    """The CLI on two ranks: each rank's batches (its contiguous rows of the
    global batch, rank 1's second row a padded copy of row 0) and the
    epoch-1 checkpoint equal bit for bit with --per-host-data on and off."""
    _, *ranks = runs
    for rank, r in enumerate(ranks):
        batches = sorted(k[len("cli-on/"):] for k in r
                         if k.startswith("cli-on/batch"))
        assert len(batches) == 2 * 4, batches
        for k in batches:
            np.testing.assert_array_equal(r[f"cli-on/{k}"],
                                          r[f"cli-off/{k}"], err_msg=k)
        assert r["cli-on/batch0/features"].shape[0] == 2
    np.testing.assert_array_equal(ranks[1]["cli-on/batch0/features"][1],
                                  ranks[0]["cli-on/batch0/features"][0])
    params = [k for k in ranks[0] if k.startswith("cli-on/param/")]
    assert params
    for k in params:
        np.testing.assert_array_equal(
            ranks[0][k], ranks[0][k.replace("cli-on", "cli-off")], err_msg=k)


def test_local_batch_rows_match_jax(monkeypatch):
    """``local_batch_rows(rank, world, B)`` against the JAX package's
    ``local_batch_rows(mesh, B)`` for the process that owns the data
    axis's device ``rank`` (one device a process), and the same
    ``ValueError`` where the world does not divide the batch."""
    from jax.sharding import NamedSharding

    from zipvoice_tpu.parallel import mesh as jax_mesh

    for n_data in (1, 2, 4):
        m = jax_mesh.make_mesh(n_data=n_data)
        for rank in range(n_data):
            device = m.devices[rank, 0]

            def owned(self, shape, device=device):
                return {d: i for d, i in
                        self.devices_indices_map(shape).items()
                        if d == device}

            with monkeypatch.context() as mp:
                mp.setattr(NamedSharding, "addressable_devices_indices_map",
                           owned)
                for B in (2, 4, 8, 16):
                    try:
                        want = jax_mesh.local_batch_rows(m, B)
                    except ValueError:
                        with pytest.raises(ValueError):
                            mesh.local_batch_rows(rank, n_data, B)
                        continue
                    np.testing.assert_array_equal(
                        mesh.local_batch_rows(rank, n_data, B), want)
