"""Process groups and data parallelism (counterpart of
``zipvoice_tpu/parallel/mesh.py``).

The JAX package trains on a ``jax.sharding.Mesh`` with the batch sharded
over a ``data`` axis, and XLA inserts the gradient all-reduce.  Here one
process drives one device, the processes form a ``torch.distributed``
group (NCCL on CUDA, gloo on the CPU), and the collectives are explicit:

- every process builds the same global batch from the same sampler and
  seed and keeps the contiguous rows that ``P('data')`` gives its device
  (``local_batch_rows``), so N processes compute what one process computes
  on the same global batch, up to the order of float sums;
- a step draws its random tensors at the global batch and keeps its own
  rows (``batch_rows`` sets ``TrainGenerators.rows``), so every process's
  generators stay equal;
- the statistics that span the batch (the loss's mask count, the
  balancer's and the whitening's sums, the downsampling's longest valid
  length, the bypass limiter's gradient sign) are all-reduced where they
  are taken (``reducing``);
- after the backward, one SUM all-reduce a dtype carries every gradient
  and the step's loss terms (``all_reduce_grads``), so every process ends
  the step with the same bits and ScaledAdam sees the global gradient.

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: gloo also
takes them on CUDA tensors, so two processes can share one card.
"""

import contextlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

# depth of ``local()`` contexts: inside one, this process computes alone
_LOCAL = [0]
# set by tensor parallelism (``sharding_rules.shard_model``) until
# ``destroy()``: the group's processes hold the same batch
_BATCH_REPLICATED = [False]


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, device="cuda",
                     backend: Optional[str] = None) -> torch.device:
    """Open the process group at ``tcp://<coordinator_address>`` (host:port
    of process 0) as process ``process_id`` of ``num_processes``; returns
    the device this process drives: ``cuda:<process_id % device_count>``
    with NCCL, or the CPU with gloo.  ``backend`` overrides the choice
    (gloo on CUDA tensors, for two processes on one card)."""
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda",
                              process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, **kw)
    return device


def destroy() -> None:
    _BATCH_REPLICATED[0] = False
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def replicate_batch() -> None:
    """Every process of the group holds the same batch from now until
    ``destroy()`` (tensor parallelism): ``reducing()`` is False, so the
    batch-wide statistics are taken locally, with no collective."""
    _BATCH_REPLICATED[0] = True


def group_active() -> bool:
    """A process group is open and no ``local()`` context is."""
    return (not _LOCAL[0] and dist.is_available()
            and dist.is_initialized())


def reducing() -> bool:
    """Batch-wide statistics must be all-reduced: a group of more than one
    process is active and splits the batch.  With one process or none, or
    a batch that every process holds whole (``replicate_batch``), this is
    False and the helpers below add no work."""
    return (group_active() and not _BATCH_REPLICATED[0]
            and dist.get_world_size() > 1)


@contextlib.contextmanager
def local():
    """Compute alone inside: no collective (the primary's validation on
    whole batches, as the JAX trainer runs it)."""
    _LOCAL[0] += 1
    try:
        yield
    finally:
        _LOCAL[0] -= 1


def local_batch_rows(rank: int, world: int, global_batch: int) -> np.ndarray:
    """The global batch rows that process ``rank`` of ``world`` holds under
    ``P('data')`` with one device a process: a contiguous block, ascending.
    A batch that ``world`` does not divide raises ``ValueError``, as the
    JAX package's sharding does."""
    if global_batch % world:
        raise ValueError(
            f"a global batch of {global_batch} rows does not split evenly "
            f"over {world} processes")
    n = global_batch // world
    return np.arange(rank * n, (rank + 1) * n, dtype=np.int64)


def batch_rows(local_batch: int):
    """(global batch, this process's row slice) for a step whose batch
    holds ``local_batch`` rows of each process, or None when no group of
    more than one process is active."""
    if not reducing():
        return None
    rank, world = dist.get_rank(), dist.get_world_size()
    return local_batch * world, slice(rank * local_batch,
                                      (rank + 1) * local_batch)


def all_reduce_(tensor: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """In place, across the group when ``reducing()``; returns it."""
    if reducing():
        dist.all_reduce(tensor, op={"sum": dist.ReduceOp.SUM,
                                    "max": dist.ReduceOp.MAX}[op])
    return tensor


def global_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (no gradient) summed over the group's processes."""
    return all_reduce_(x.detach().clone()) if reducing() else x


def global_max(x: torch.Tensor) -> torch.Tensor:
    """``x`` (no gradient), its largest value over the group's processes."""
    return all_reduce_(x.detach().clone(), "max") if reducing() else x


def _coalesced(tensors, collective) -> None:
    """Run ``collective`` on one flat buffer a dtype holding ``tensors``,
    and copy the result back into them."""
    buckets = {}
    for t in tensors:
        buckets.setdefault(t.dtype, []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        collective(flat)
        offset = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[offset: offset + n].view_as(t))
            offset += n


def all_reduce_grads(params, *extra: torch.Tensor) -> None:
    """SUM every gradient of ``params`` that exists, and the ``extra``
    tensors (a step's loss terms), over the group in place: one all-reduce
    a dtype.  Every process must hold gradients for the same parameters
    (a step's coins are equal on every process, so they do).  No work
    unless ``reducing()``."""
    if not reducing():
        return
    tensors = [p.grad for p in params if p.grad is not None]
    _coalesced(tensors + list(extra), dist.all_reduce)


def broadcast_params(module: torch.nn.Module) -> None:
    """Copy process 0's parameters into every process's ``module``; no
    work unless ``reducing()``."""
    if not reducing():
        return
    with torch.no_grad():
        _coalesced([p.data for p in module.parameters()],
                   lambda flat: dist.broadcast(flat, 0))


def barrier() -> None:
    if group_active():
        dist.barrier()
