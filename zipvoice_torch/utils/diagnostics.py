"""Diagnostics (counterpart of
``zipvoice_tpu/utils/diagnostics.py``).

The reference's forward-hook machinery (zipvoice/utils/diagnostics.py:
per-module tensor stats; zipvoice/utils/hooks.py: inf/NaN checks), which
the JAX package replaced with ``capture_intermediates``, is forward hooks
again here:

- ``collect_module_stats``: runs a forward with a hook on every module and
  reports abs/rms/min/max percentiles of every module output (the
  ``--print-diagnostics`` dump);
- ``NonfiniteMonitor``: the ``--inf-check`` hooks of a training run, which
  name the modules whose outputs hold inf/NaN in the order they finished;
  ``find_nonfinite`` does the same for a tree of tensors (weights,
  gradients).

The statistics are the JAX package's numpy code, on host copies in f32.
"""

from typing import Any, Callable, Dict

import numpy as np
import torch

_PCTS = (0, 10, 20, 30, 40, 50, 60, 70, 80, 90, 100)


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _stats(x) -> Dict[str, float]:
    x = _numpy(x).ravel()
    if x.size == 0:
        return {}
    ax = np.abs(x)
    return {
        "shape": None,
        "mean": float(x.mean()),
        "rms": float(np.sqrt(np.mean(x * x))),
        "abs_p50": float(np.percentile(ax, 50)),
        "abs_p95": float(np.percentile(ax, 95)),
        "max": float(x.max()),
        "min": float(x.min()),
        "frac_pos": float((x > 0).mean()),
    }


def dimwise_stats(x, max_dim_size: int = 2048) -> Dict[int, Dict]:
    """Per-dimension statistics in the reference's TensorDiagnostic style
    (reference diagnostics.py:29-400): for each axis, reduce every OTHER
    axis to get one value per index, then report the [0,10,...,100]
    percentiles across indices of mean |x| ("abs"), the positive fraction
    ("positive"), the rms ("rms") and the mean value ("value"), plus, for
    the trailing (channel) axis, the eigenvalue percentiles of the feature
    covariance ("eigs", reference diagnostics.py:184-220) when the axis is
    small enough."""
    x = _numpy(x)
    out: Dict[int, Dict] = {}
    for d in range(x.ndim):
        if x.shape[d] < 2 or x.shape[d] > max_dim_size:
            continue
        other = tuple(i for i in range(x.ndim) if i != d)
        ax = np.abs(x)
        stats = {
            "size": x.shape[d],
            "abs": np.percentile(ax.mean(axis=other), _PCTS),
            "positive": np.percentile((x > 0).mean(axis=other), _PCTS),
            "rms": np.percentile(np.sqrt((x * x).mean(axis=other)), _PCTS),
            "value": np.percentile(x.mean(axis=other), _PCTS),
        }
        if d == x.ndim - 1 and x.ndim >= 2 and x.shape[d] <= 512:
            flat = x.reshape(-1, x.shape[d])
            if flat.shape[0] >= 2:
                cov = np.cov(flat, rowvar=False)
                eigs = np.linalg.eigvalsh(np.atleast_2d(cov))
                stats["eigs"] = np.percentile(eigs, _PCTS)
        out[d] = stats
    return out


def _fmt_pcts(v) -> str:
    return "[" + " ".join(f"{float(x):.2g}" for x in v) + "]"


def _leaves(tree: Any, prefix: str = ""):
    """(path, leaf) of a nested mapping of tensors or arrays, the path's
    keys joined by "/" as the JAX package names a pytree's leaves."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif hasattr(tree, "shape"):
        yield prefix[:-1], tree


def _tensor_stats(x, dimwise: bool = True) -> Dict:
    s = _stats(x)
    s["shape"] = tuple(x.shape)
    if dimwise:
        s["dims"] = dimwise_stats(x)
    return s


def collect_tree_stats(tree: Any, dimwise: bool = True) -> Dict[str, Dict]:
    """Dim-wise stats for every tensor of a (nested) mapping: used on
    ``dict(model.named_parameters())`` and on their gradients (the
    reference attaches diagnostics to parameters and their .grad,
    diagnostics.py:442-570)."""
    return {name: _tensor_stats(leaf, dimwise)
            for name, leaf in _leaves(tree)}


class ModuleOutputs:
    """A forward hook on every module of ``model`` until ``remove()`` (or
    the end of a ``with`` block): ``out`` holds {name: reduce(output)},
    filled in the order the modules finish, a tuple output's tensors as
    ``name[i]``, a module's later calls as ``name#2``, ``name#3``, ..."""

    def __init__(self, model: torch.nn.Module, reduce: Callable):
        self.out: Dict[str, Any] = {}
        self._reduce = reduce
        self._handles = [
            m.register_forward_hook(self._hook(n or type(model).__name__))
            for n, m in model.named_modules()]

    def _hook(self, name):
        def record(module, inputs, output):
            outs = output if isinstance(output, (tuple, list)) else (output,)
            for i, o in enumerate(outs):
                if not torch.is_tensor(o):
                    continue
                key = name if len(outs) == 1 else f"{name}[{i}]"
                k, n = key, 1
                while k in self.out:
                    n += 1
                    k = f"{key}#{n}"
                self.out[k] = self._reduce(o)
        return record

    def remove(self) -> None:
        for h in self._handles:
            h.remove()

    def __enter__(self):
        return self.out

    def __exit__(self, *exc):
        self.remove()


def _run(model, args, method, kwargs):
    fn = getattr(model, method) if method else model
    with torch.no_grad():
        return fn(*args, **kwargs)


def collect_module_stats(model: torch.nn.Module, *args, method=None,
                         **kwargs) -> Dict[str, Dict]:
    """Run ``model(*args, **kwargs)`` (or ``model.<method>``) without
    gradients and return the stats of every module's output (the
    --print-diagnostics analogue, reference diagnostics.py:570+); softmaxed
    attention weights also get their entropy."""
    def reduce(o):
        s = _tensor_stats(o)
        if _looks_like_attention(o):
            # attention-entropy diagnostic (reference zipformer.py:
            # 1299-1322 randomly logs it at eval): mean over rows of
            # -sum(w log w), in nats
            w = _numpy(o)
            ent = -np.sum(w * np.log(np.clip(w, 1e-20, None)), axis=-1)
            s["attn_entropy_mean"] = float(ent.mean())
            s["attn_entropy_p95"] = float(np.percentile(ent, 95))
        return s

    with ModuleOutputs(model, reduce) as stats:
        _run(model, args, method, kwargs)
    return stats


def _looks_like_attention(x: torch.Tensor) -> bool:
    """Softmaxed attention weights: a 4-dim (B, h, T, T) output whose rows
    sum to ~1."""
    if x.dim() != 4 or x.shape[-1] != x.shape[-2]:
        return False
    rows = x[..., :1, :].float().sum(dim=-1)
    return bool(((rows - 1.0).abs() < 1e-2).all())


def _count_nonfinite(x) -> int:
    if torch.is_tensor(x):
        if not x.is_floating_point():
            return 0
        return int((~torch.isfinite(x)).sum())
    x = np.asarray(x)
    if not np.issubdtype(x.dtype, np.floating):
        return 0
    return int((~np.isfinite(x)).sum())


def find_nonfinite(tree: Any, prefix: str = "") -> Dict[str, int]:
    """{path: count of non-finite values} for every offending floating
    leaf of a (nested) mapping of tensors or arrays."""
    bad = {}
    for name, leaf in _leaves(tree):
        n = _count_nonfinite(leaf)
        if n:
            bad[prefix + name] = n
    return bad


def _nonfinite_on_device(x: torch.Tensor):
    if not x.is_floating_point():
        return None
    return (~torch.isfinite(x.detach())).sum()


class NonfiniteMonitor(ModuleOutputs):
    """The ``--inf-check`` hooks of a training run: every module output's
    count of non-finite values, kept on the device (no hook waits for
    it); ``found()`` reads them, the first being where they arose, and
    ``clear()`` starts the next step."""

    def __init__(self, model: torch.nn.Module):
        super().__init__(model, _nonfinite_on_device)

    def clear(self) -> None:
        self.out.clear()

    def found(self) -> Dict[str, int]:
        counts = {k: v for k, v in self.out.items() if v is not None}
        if not counts:
            return {}
        values = torch.stack(list(counts.values())).tolist()
        return {k: n for k, n in zip(counts, values) if n}


def assert_all_finite(tree: Any, what: str = "tree") -> None:
    bad = find_nonfinite(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {what}: {bad}")


def format_stats(stats: Dict[str, Dict], top: int = 0,
                 dimwise: bool = True) -> str:
    lines = []
    items = stats.items()
    if top:
        items = sorted(items, key=lambda kv: -kv[1].get("abs_p95", 0.0))[:top]
    for name, s in items:
        lines.append(
            f"{name} shape={s.get('shape')} rms={s.get('rms', 0):.3g} "
            f"abs[p50={s.get('abs_p50', 0):.3g} "
            f"p95={s.get('abs_p95', 0):.3g}] "
            f"range=[{s.get('min', 0):.3g},{s.get('max', 0):.3g}] "
            f"pos={s.get('frac_pos', 0):.2f}"
        )
        if dimwise:
            for d, ds in (s.get("dims") or {}).items():
                for key in ("abs", "positive", "rms", "value", "eigs"):
                    if key in ds:
                        lines.append(
                            f"  dim={d} size={ds['size']} {key} "
                            f"percentiles {_fmt_pcts(ds[key])}"
                        )
    return "\n".join(lines)
