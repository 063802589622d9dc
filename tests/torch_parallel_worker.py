"""The processes of a gloo group for tests/test_torch_parallel.py (on the
CPU) and tests/test_torch_gpu.py (on one card); it imports no JAX.

On the CPU the test forks them from a ``multiprocessing`` forkserver that
has imported torch, ``torch._dynamo`` and this module once
(``FORKSERVER_PRELOAD``): each of ``jobs()`` is a pair of ranks, a
process of ``child``, that runs one scenario of ``SCENARIOS`` on its rows
of the same global batch, or the trainer CLI with ``--per-host-data on``
or ``off``, and writes an .npz.  ``run_scenarios`` with a world of one is
the one-process reference that the tests compute themselves.  The same
forkserver forks tests/test_torch_tensor_parallel.py's ranks
(``tp_child``: a tensor-parallel ``forward_fm_decoder``) and
tests/test_torch_vocos.py's import check (``import_check``).  On the
card the test starts the processes as scripts, each running every
scenario:

  python tests/torch_parallel_worker.py RANK WORLD PORT OUT [--device cuda]

On CUDA, f32 matmuls run without TF32.
"""

import argparse
import os
import socket
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from zipvoice_torch.models.zipvoice import build_zipvoice  # noqa: E402
from zipvoice_torch.parallel import mesh  # noqa: E402
from zipvoice_torch.train.distill import make_distill_train_step  # noqa
from zipvoice_torch.train.optim import ScaledAdam  # noqa: E402
from zipvoice_torch.train.train_step import make_train_step  # noqa: E402

# the JAX package's multi-process test model (__graft_entry__._TINY_CFG)
CONFIG = dict(
    fm_decoder_downsampling_factor=(1, 2, 1),
    fm_decoder_num_layers=(1, 1, 1),
    fm_decoder_cnn_module_kernel=(7, 7, 7),
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
    feat_dim=16,
    vocab_size=40,
    pad_id=0,
)
STEPS = 4
B, T = 4, 24
# the manifest that the test's corpus holds
MANIFEST = "toy_cuts_train.jsonl.gz"


def free_ports(n):
    """``n`` distinct free TCP ports on 127.0.0.1."""
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def global_batch(padded_rows: bool = False):
    """tests/test_multiprocess_train.py's batch: four rows of the same
    tokens and random features.  With ``padded_rows`` rows 2 and 3 are all
    padding (no token, no frame), so that a process of two holds no frame
    of the loss."""
    rng = np.random.RandomState(0)
    batch = {
        "tokens": np.tile(np.array([[3, 5, 7, 2, 0, 0]], np.int64), (B, 1)),
        "tokens_lens": np.full((B,), 4, np.int64),
        "features": rng.randn(B, T, CONFIG["feat_dim"]).astype(np.float32),
        "features_lens": np.full((B,), T, np.int64),
    }
    if padded_rows:
        batch["features_lens"][:] = [T, T - 5, 0, 0]
        batch["tokens_lens"][2:] = 0
        batch["tokens"][2:] = 0
        batch["features"][2:] = 0.0
    return batch


def rows_of(batch, rank: int, world: int, device="cpu"):
    rows = mesh.local_batch_rows(rank, world, B)
    return {k: torch.from_numpy(v[rows]).to(device) for k, v in batch.items()}


# name: (train-step settings, batch, distill), each at lr 0.03
SCENARIOS = {
    # tests/test_multiprocess_train.py:66-79
    "jax_settings": (dict(condition_drop_ratio=0.0, dropout_rate=0.0),
                     False, False),
    "dropout": (dict(condition_drop_ratio=0.2, dropout_rate=0.1),
                False, False),
    "padded_rank": (dict(condition_drop_ratio=0.2, dropout_rate=0.1),
                    True, False),
    "distill": ({}, False, True),
}


def run_scenario(name: str, rank: int, world: int, device="cpu"):
    """(per-step losses, final parameters, each parameter's largest |grad|
    over the steps) of ``STEPS`` steps on this process's rows."""
    settings, padded_rows, distill = SCENARIOS[name]
    model = build_zipvoice(distill=distill, device=device, seed=0,
                           train=True, **CONFIG)
    optimizer = ScaledAdam(model.parameters(), lr=0.03)
    if distill:
        teacher = build_zipvoice(device=device, seed=1, **CONFIG)
        step = make_distill_train_step(model, teacher, optimizer,
                                       stage="first", max_duration=50.0,
                                       seed=3)
    else:
        step = make_train_step(model, optimizer, schedules=True,
                               max_duration=50.0, seed=3, **settings)
    batch = rows_of(global_batch(padded_rows), rank, world, device)
    named = dict(model.named_parameters())
    losses, grads = [], {k: torch.zeros_like(p) for k, p in named.items()}
    for _ in range(STEPS):
        losses.append(float(step(batch)["loss"]))
        for k, p in named.items():
            if p.grad is not None:
                torch.maximum(grads[k], p.grad.abs(), out=grads[k])
    params = {k: v.detach().cpu().numpy().copy()
              for k, v in model.state_dict().items()}
    return np.array(losses), params, grads


def run_scenarios(rank: int, world: int, device="cpu", names=SCENARIOS):
    out = {}
    for name in names:
        losses, params, grads = run_scenario(name, rank, world, device)
        out[f"{name}/loss"] = losses
        out.update({f"{name}/param/{k}": v for k, v in params.items()})
        out.update({f"{name}/grad/{k}": v.cpu().numpy()
                    for k, v in grads.items()})
    return out


# a gradient that is not zero but at most this share of its leaf's largest
# is zero up to f32 rounding (eight ulps at the leaf's scale)
ROUNDING = 1e-6
# at most this share of a scenario's parameter elements may be such
MAX_ROUNDING_SHARE = 1e-2


def check_against_one_process(solo, r0, r1, scenario):
    """Two processes' results (``r0``, ``r1``) against one process's
    (``solo``) for ``scenario``: the losses within 1e-5 relative, the
    parameters within atol 1e-5, rtol 1e-4 and both processes' results
    equal bit for bit.  Parameter elements whose one-process gradient is
    zero up to rounding (``ROUNDING``; the key projection's bias, to which
    softmax is blind) take ScaledAdam's step in the direction of that
    rounding, which the order of a sum decides, so they are held only to
    the bit-equality of the two processes.  Returns (the largest share of
    the bound that a held element used, the elements not held, the
    elements)."""
    np.testing.assert_allclose(r0[f"{scenario}/loss"],
                               solo[f"{scenario}/loss"], rtol=1e-5)
    np.testing.assert_array_equal(r0[f"{scenario}/loss"],
                                  r1[f"{scenario}/loss"])
    prefix = f"{scenario}/param/"
    keys = [k for k in solo if k.startswith(prefix)]
    assert keys
    worst, skipped, total = 0.0, 0, 0
    for k in keys:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        want = solo[k]
        held = np.ones(want.shape, bool)
        grad = solo.get(f"{scenario}/grad/{k[len(prefix):]}")
        if grad is not None:
            held = ~((grad > 0) & (grad <= ROUNDING * grad.max()))
        np.testing.assert_allclose(r0[k][held], want[held], atol=1e-5,
                                   rtol=1e-4, err_msg=k)
        ratio = np.abs(r0[k] - want) / (1e-5 + 1e-4 * np.abs(want))
        worst = max(worst, float(ratio[held].max(initial=0.0)))
        skipped += int((~held).sum())
        total += want.size
    assert skipped <= MAX_ROUNDING_SHARE * total, (skipped, total)
    return worst, skipped, total


def run_cli(corpus: str, port: int, rank: int, world: int, per_host: str):
    """The trainer CLI as process ``rank``: one epoch of two steps; returns
    the batches its steps took (this process's rows) and, on process 0,
    the ``epoch-1`` checkpoint's parameters."""
    from zipvoice_torch.bin import train_zipvoice
    from zipvoice_torch.utils import checkpoint_io

    taken = []
    on_device = train_zipvoice.on_device

    def recording(batch, device):
        taken.append({k: np.asarray(batch[k]) for k in (
            "features", "features_lens", "tokens", "tokens_lens")})
        return on_device(batch, device)

    train_zipvoice.on_device = recording
    exp = os.path.join(corpus, f"exp-{per_host}")
    try:
        train_zipvoice.main([
            "--train-manifest", os.path.join(corpus, MANIFEST),
            "--token-file", os.path.join(corpus, "tokens.txt"),
            "--tokenizer", "simple", "--model-config",
            os.path.join(corpus, "model.json"), "--exp-dir", exp,
            "--max-duration", "4", "--num-buckets", "1", "--base-lr", "0.01",
            "--log-interval", "1", "--save-every-n", "0",
            "--average-period", "1", "--no-bf16", "--platform", "cpu",
            "--num-workers", "1", "--num-epochs", "1",
            "--coordinator-address", f"127.0.0.1:{port}",
            "--num-processes", str(world), "--process-id", str(rank),
            "--per-host-data", per_host])
    finally:
        train_zipvoice.on_device = on_device
    out = {f"cli-{per_host}/batch{i}/{k}": v
           for i, b in enumerate(taken) for k, v in b.items()}
    if rank == 0:
        sd = checkpoint_io.load_checkpoint(os.path.join(exp, "epoch-1"))[0]
        out.update({f"cli-{per_host}/param/{k}": v.numpy()
                    for k, v in sd.items()})
    return out


# tests/test_torch_tensor_parallel.py: tests/test_tensor_parallel.py's model
# (CONFIG at fm_decoder dim 64, feed-forward 128: 4 heads, hidden widths
# 48, 96, 128 and 160) and forward_fm_decoder inputs
TP_CONFIG = dict(CONFIG, fm_decoder_dim=64, fm_decoder_feedforward_dim=128)
TP_B, TP_T = 2, 32


def tp_state_dict(seed: int = 0):
    """The reference-layout weights of the tensor-parallel test model, as
    numpy: the port's init from ``seed``, every weight perturbed so that no
    init constant hides a wiring fault."""
    rng = np.random.RandomState(seed)
    model = build_zipvoice(device="cpu", seed=seed, **TP_CONFIG)
    return {k: np.asarray(v.numpy() + np.float32(0.05)
                          * np.asarray(rng.randn(*v.shape), np.float32))
            for k, v in model.state_dict().items()}


def tp_inputs(seed: int = 1):
    """forward_fm_decoder's inputs, as numpy: the second row's last 5
    frames padded."""
    rng = np.random.RandomState(seed)
    F = TP_CONFIG["feat_dim"]
    xt, tc, sc = (rng.randn(TP_B, TP_T, F).astype(np.float32)
                  for _ in range(3))
    mask = np.zeros((TP_B, TP_T), bool)
    mask[1, -5:] = True
    return dict(t=np.full((TP_B,), 0.5, np.float32), xt=xt,
                text_condition=tc, speech_condition=sc, padding_mask=mask)


def run_tp_forward(device="cpu"):
    """This process's tensor-parallel forward_fm_decoder (the whole model
    with no group open): (output, the modules split and kept whole, the
    parameter bytes this process holds)."""
    from zipvoice_torch.parallel.sharding_rules import shard_model

    model = build_zipvoice(device=device, **TP_CONFIG)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in tp_state_dict().items()})
    counts = shard_model(model)
    held = sum(p.numel() * p.element_size() for p in model.parameters())
    with torch.inference_mode():
        out = model.forward_fm_decoder(**{
            k: torch.from_numpy(v).to(device) for k, v in tp_inputs().items()})
    return out.cpu().numpy(), counts, held


def tp_child(rank: int, world: int, port: int, out: str):
    """A forked process of the tensor-parallel test: rank ``rank`` of a
    gloo group of ``world``; writes its output to ``out``, or the traceback
    to ``out + ".err"``."""
    torch.set_num_threads(1)
    try:
        mesh.init_distributed(f"127.0.0.1:{port}", world, rank, "cpu")
        try:
            y, counts, held = run_tp_forward()
            # the ranks hold one batch: no batch statistic is all-reduced
            reducing = mesh.reducing()
        finally:
            mesh.destroy()
        np.savez(out, out=y, held=held, reducing=int(reducing), **counts)
    except BaseException:
        import traceback

        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_group(names, rank: int, world: int, port: int, device="cpu"):
    """The scenarios ``names`` as process ``rank`` of a gloo group of
    ``world`` at ``port``."""
    device = mesh.init_distributed(f"127.0.0.1:{port}", world, rank, device,
                                   backend="gloo")
    try:
        return run_scenarios(rank, world, device, names)
    finally:
        mesh.destroy()


def import_check(out: str):
    """In a forked process of the forkserver (which imports no JAX): import
    every zipvoice_torch module, then write the modules of jax, flax, the
    JAX package, tools/ and egs/ found in ``sys.modules`` and the port's
    modules there, as JSON, to ``out``."""
    import importlib
    import json
    import pkgutil

    import zipvoice_torch

    for m in pkgutil.walk_packages(zipvoice_torch.__path__,
                                   "zipvoice_torch."):
        importlib.import_module(m.name)
    with open(out, "w") as f:
        json.dump({
            "bad": sorted(m for m in sys.modules if m.split(".")[0] in (
                "jax", "jaxlib", "flax", "zipvoice_tpu", "tools", "egs")),
            "port": sorted(m for m in sys.modules
                           if m.startswith("zipvoice_torch."))}, f)


# what the forkserver imports once for every process it forks
FORKSERVER_PRELOAD = ["torch._dynamo", "torch_parallel_worker",
                      "zipvoice_torch.bin.train_zipvoice",
                      "zipvoice_torch.parallel.sharding_rules"]


def jobs():
    """The CPU test's pairs of ranks: ("steps", a scenario) or ("cli", the
    ``--per-host-data`` value)."""
    return ([("steps", name) for name in SCENARIOS]
            + [("cli", "on"), ("cli", "off")])


def child(job, rank: int, world: int, port: int, out: str, corpus: str):
    """A forked process of ``job`` (one of ``jobs()``): writes its results
    to ``out``, or the traceback to ``out + ".err"`` and exits 1."""
    torch.set_num_threads(1)
    kind, arg = job
    try:
        if kind == "steps":
            result = run_group([arg], rank, world, port)
        else:
            result = run_cli(corpus, port, rank, world, arg)
        np.savez(out, **result)
    except BaseException:
        import traceback

        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def main():
    p = argparse.ArgumentParser()
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("port", type=int)
    p.add_argument("out", type=str)
    p.add_argument("--device", type=str, default="cpu")
    args = p.parse_args()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    np.savez(args.out, **run_group(list(SCENARIOS), args.rank, args.world,
                                   args.port, args.device))
    print(f"rank {args.rank} done", flush=True)


if __name__ == "__main__":
    main()
