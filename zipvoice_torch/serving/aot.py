"""Exported sampling engines: ``torch.export`` programs replayed as CUDA
graphs (counterpart of ``zipvoice_tpu/serving/aot.py``).

The JAX package serializes the jitted ``sample`` program per (batch, token,
frame) bucket as StableHLO and rebuilds the XLA executable from it on load.
Here each bucket is a pair of ``torch.export`` programs, saved as ``.pt2``:

- ``condition``: the text encoder, the upsampling to frames and the prompt
  mask (``ZipVoice.sample_condition``);
- ``step``: one Euler step with its guidance rule (``ZipVoice.sample_step``),
  the body of JAX's ``lax.scan`` over steps, which the engine runs
  ``num_step`` times on the manifest's time grid.  Unrolling the steps into
  one program would make a program, its export and its load ``num_step``
  times longer.

The weights are program inputs, not stored in the files (as JAX's
``fn(params, ...)``): an engine runs on the weights of the model it is
attached to.  What the model's code reads at trace time is baked into the
programs, so the manifest records it and ``load_engine_dir`` refuses a
model that differs: the kernel switches and gates, the weights' names,
shapes and dtypes, the model class, the device type and the torch version.

On a CUDA device an engine runs its programs once uncaptured (which builds
the kernels' libraries and warms cuBLAS and the allocator), then captures
the whole sample (the condition and every step) as one ``torch.cuda.CUDAGraph``
with static input and output buffers; all engines of a directory share one
graph memory pool.  A call then copies its inputs into the static buffers
and replays.  That capture is the H100's counterpart of "the XLA
executable, rebuilt from the portable artifact on load".  On the CPU the
programs run uncaptured.

Artifacts: ``sample_b{B}_s{S}_t{T}_n{N}.{condition,step}.pt2`` per bucket
and ``manifest.json`` (JAX's ``num_step``, ``guidance_scale``, ``t_shift``
and ``buckets``, plus the traced state above).
"""

import contextlib
import ctypes
import json
import os
import time
import types
import typing
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn

from zipvoice_torch.models import zipformer
from zipvoice_torch.models.solver import get_time_steps


def _sample_args(model, B: int, S: int, T: int, device) -> Dict:
    """Zero inputs of the programs at one (B, S, T) bucket."""
    F = model.feat_dim

    def ints(n):
        return torch.full((B,), n, dtype=torch.int64, device=device)

    return dict(
        tokens=torch.zeros((B, S), dtype=torch.int64, device=device),
        tokens_lens=ints(1),
        prompt_features=torch.zeros((B, T, F), device=device),
        prompt_features_lens=ints(1),
        features_lens=ints(T),
        noise=torch.zeros((B, T, F), device=device),
    )


def _named_tensors(model) -> Dict[str, torch.Tensor]:
    """The model's weights by name: the programs' first input, in order."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def _switches(model) -> Dict[str, list]:
    """[modules on, modules] of each kernel switch under ``model``."""
    found = {
        "attention_kernel": [
            m.use_kernel for m in model.modules()
            if isinstance(m, zipformer.RelPosAttentionWeights)],
        "fuse_nonlin": [m.fuse_nonlin for m in model.modules()
                        if isinstance(m, zipformer.ZipformerEncoderLayer)],
        "apply_kernel": [m.use_kernel for m in model.modules()
                         if isinstance(m, zipformer.SelfAttention)],
        "conv_kernel": [m.use_kernel for m in model.modules()
                        if isinstance(m, zipformer.ConvolutionModule)],
    }
    return {k: [sum(map(bool, v)), len(v)] for k, v in found.items()}


def traced_state(model) -> Dict:
    """What the model's code reads while it is traced, and so what a
    program holds as constants: an engine is only valid for a model and a
    process that give the same."""
    tensors = _named_tensors(model)
    compute = sorted({str(m.compute_dtype) for m in model.modules()
                      if getattr(m, "compute_dtype", None) is not None})
    return {
        "model_class": type(model).__name__,
        "device": next(iter(tensors.values())).device.type,
        "dtype": str(next(model.fm_decoder.parameters()).dtype),
        "compute_dtypes": compute,
        "kernel_switches": _switches(model),
        "min_seq_len": zipformer.MIN_SEQ_LEN,
        "min_apply_seq_len": zipformer.MIN_APPLY_SEQ_LEN,
        "torch": torch.__version__,
        "weights": [[n, list(t.shape), str(t.dtype)]
                    for n, t in tensors.items()],
    }


class _Condition(nn.Module):
    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, tokens, tokens_lens, prompt_features,
                prompt_features_lens, features_lens):
        return self.model.sample_condition(tokens, tokens_lens,
                                           prompt_features,
                                           prompt_features_lens,
                                           features_lens)


class _Step(nn.Module):
    def __init__(self, model, guidance_scale: float):
        super().__init__()
        self.model = model
        self.guidance_scale = guidance_scale

    def forward(self, x, t, t_next, text_condition, speech_condition,
                padding_mask):
        return self.model.sample_step(x, t, t_next, text_condition,
                                      speech_condition, padding_mask,
                                      self.guidance_scale)


class _WeightsAsInputs(nn.Module):
    """``call(*inputs)`` on the weights passed in as the first argument (a
    tuple in ``names``' order) in place of the model's own.  ``call`` is
    held outside the module tree, so the exported program has no
    parameters and its file no weights."""

    def __init__(self, call: nn.Module, names: Sequence[str]):
        super().__init__()
        self.__dict__["call"] = call
        self.names = ["model." + n for n in names]

    def forward(self, weights, *inputs):
        return torch.func.functional_call(
            self.call, dict(zip(self.names, weights)), inputs)


def trace_programs(model, B: int, S: int, T: int, guidance_scale: float):
    """Yield ("condition", program) then ("step", program): ``model``'s
    sampling programs at one (B, S, T) bucket, traced by ``torch.export``
    on the model's device in its current configuration, with its weights
    as the first input.  Each is traced when it is asked for."""
    tensors = _named_tensors(model)
    names, weights = list(tensors), tuple(tensors.values())
    a = _sample_args(model, B, S, T, weights[0].device)
    cond_in = (a["tokens"], a["tokens_lens"], a["prompt_features"],
               a["prompt_features_lens"], a["features_lens"])
    with torch.no_grad():
        tc, sc, pm = model.sample_condition(*cond_in)
    # two tensors: one passed twice would trace as one input
    t = [torch.zeros((), device=tc.device) for _ in range(2)]
    for name, module, inputs in (
            ("condition", _Condition(model), cond_in),
            ("step", _Step(model, guidance_scale),
             (a["noise"], t[0], t[1], tc, sc, pm))):
        with torch.no_grad():
            ep = torch.export.export(_WeightsAsInputs(module, names),
                                     (weights, *inputs), strict=False)
        yield name, ep


def export_sample_program(
    model,
    out_dir: str,
    buckets: Sequence[Tuple[int, int, int]] = ((1, 128, 1024),),
    num_step: int = 16,
    guidance_scale: float = 1.0,
    t_shift: float = 0.5,
) -> Dict:
    """Export ``model``'s sampling programs for each (B, S, T) bucket on
    the model's device into ``out_dir``; returns the manifest, which also
    records each bucket's export seconds and file bytes."""
    os.makedirs(out_dir, exist_ok=True)
    manifest = {
        "num_step": num_step,
        "guidance_scale": guidance_scale,
        "t_shift": t_shift,
        "buckets": [],
        **traced_state(model),
    }
    for B, S, T in buckets:
        start = time.perf_counter()
        stem = f"sample_b{B}_s{S}_t{T}_n{num_step}"
        entry = {"B": B, "S": S, "T": T, "bytes": 0}
        for name, ep in trace_programs(model, B, S, T, guidance_scale):
            entry[name] = f"{stem}.{name}.pt2"
            path = os.path.join(out_dir, entry[name])
            # the example inputs hold the weights: saved, they would fill
            # the file
            ep._example_inputs = None
            torch.export.save(ep, path)
            entry["bytes"] += os.path.getsize(path)
        entry["export_s"] = time.perf_counter() - start
        manifest["buckets"].append(entry)

    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def _graph_nodes(graph: "torch.cuda.CUDAGraph") -> int:
    """Nodes of a captured graph (kernels, copies, memsets), from
    libcuda's ``cuGraphGetNodes``."""
    count = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUDA error {err}")
    return count.value


class ExportedEngine:
    """One bucket's sampling programs bound to a model's weights.

    ``engine(tokens, tokens_lens, prompt_tokens_lens, prompt_features,
    prompt_features_lens, features_lens, noise)`` returns (x1,
    padding_mask) as ``ZipVoice.sample`` does.  On a CUDA device the first
    call (or ``prepare``) runs the programs uncaptured and captures them;
    every call after replays the graph on the caller's current stream and
    returns the graph's static output buffers, which the next call
    overwrites: consume them on the same stream first.  One engine's
    calls, and all calls of engines that share a pool, belong on one
    stream.  The graph reads the weights where they were at capture:
    update them in place, not by replacing the tensors."""

    def __init__(self, condition, step, weights, ts, pool=None):
        self.condition = condition
        self.step = step
        self.weights = tuple(weights)
        self.ts = ts
        self.pool = pool
        self.graph = None
        self.stats: Dict = {}
        self._static_in = self._static_out = None

    def run(self, tokens, tokens_lens, prompt_tokens_lens, prompt_features,
            prompt_features_lens, features_lens, noise):
        """The programs, uncaptured: (x1, padding_mask)."""
        tc, sc, pm = self.condition(self.weights, tokens, tokens_lens,
                                    prompt_features, prompt_features_lens,
                                    features_lens)
        x = noise.float()
        for i in range(len(self.ts) - 1):
            x = self.step(self.weights, x, self.ts[i], self.ts[i + 1], tc,
                          sc, pm)
        return x, pm

    def prepare(self, *inputs) -> None:
        """Run uncaptured once, then capture (CUDA only), with ``inputs``
        (device tensors of the bucket's shapes) as the first static
        inputs.  Records ``capture_s``, ``pool_bytes`` (bytes the capture
        added to the allocator's reservation) and ``graph_nodes``."""
        if self.graph is not None or self.ts.device.type != "cuda":
            return
        start = time.perf_counter()
        self._static_in = [x.detach().clone() for x in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.run(*self._static_in)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        # the capture empties the allocator's cache first: empty it here,
        # so that what it reserves after is the graph pool's growth
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # thread_local: other threads (a server's finisher) may go on
        # allocating and synchronizing while this one captures
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            self._static_out = self.run(*self._static_in)
        graph.instantiate()
        self.stats["graph_nodes"] = _graph_nodes(graph)
        torch.cuda.synchronize()
        self.graph = graph
        self.stats["capture_s"] = time.perf_counter() - start
        self.stats["pool_bytes"] = torch.cuda.memory_reserved() - reserved

    def __call__(self, *inputs):
        if self.ts.device.type != "cuda":
            return self.run(*inputs)
        if self.graph is None:
            self.prepare(*[x.to(self.ts.device) for x in inputs])
        for buf, x in zip(self._static_in, inputs):
            buf.copy_(x, non_blocking=True)
        self.graph.replay()
        return self._static_out


def check_traced_state(manifest: Dict, model) -> None:
    """Raise ``ValueError`` naming every traced key in which ``manifest``
    and ``model`` (in this process) differ."""
    want = traced_state(model)
    bad = [f"{k}: engines {manifest.get(k)!r}, model {v!r}"
           for k, v in want.items() if k != "weights"
           and manifest.get(k) != v]
    got = {n: (tuple(s), d) for n, s, d in manifest.get("weights", [])}
    wanted = {n: (tuple(s), d) for n, s, d in want["weights"]}
    if got != wanted:
        diff = sorted(set(got.items()) ^ set(wanted.items()))[:4]
        bad.append(f"weights differ (first: {diff})")
    if bad:
        raise ValueError("the engines were exported from another model or "
                         "setting: " + "; ".join(bad))


@contextlib.contextmanager
def _memoized_type_hints():
    """Within the block, ``torch.export.load`` evaluates each schema
    class's type hints once.  Its JSON decoder
    (``torch._export.serde.serialize._dict_to_dataclass``) evaluates them
    again for every object it builds, which is most of a load; the schema
    does not change while it loads.  A torch whose decoder does not read
    ``typing`` there loads as it would without the block."""
    from torch._export.serde import serialize

    if getattr(serialize, "typing", None) is not typing:
        yield
        return
    memo = {}

    def get_type_hints(obj, globalns=None, localns=None,
                       include_extras=False):
        key = (obj, include_extras)
        if key not in memo:
            memo[key] = typing.get_type_hints(obj, globalns, localns,
                                              include_extras)
        return memo[key]

    serialize.typing = types.SimpleNamespace(
        **{**vars(typing), "get_type_hints": get_type_hints})
    try:
        yield
    finally:
        serialize.typing = typing


def load_engine_dir(path: str, model):
    """Load an engine directory produced by ``export_sample_program`` and
    bind it to ``model``'s weights.

    Returns (manifest, {(B, S, T): ExportedEngine}); on a CUDA device all
    engines share one graph memory pool, and each captures at its first
    call or ``prepare``.  Raises ``ValueError`` if the manifest's traced
    state differs from the model's (``check_traced_state``)."""
    # the programs name the kernels' operators, registered on import
    import zipvoice_torch.kernels.depthwise_conv  # noqa: F401
    import zipvoice_torch.kernels.rel_pos_attention  # noqa: F401

    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    check_traced_state(manifest, model)
    tensors = _named_tensors(model)
    weights = [tensors[n] for n, _, _ in manifest["weights"]]
    device = weights[0].device
    ts = torch.from_numpy(get_time_steps(0.0, 1.0, manifest["num_step"],
                                         manifest["t_shift"])).to(device)
    pool = (torch.cuda.graph_pool_handle() if device.type == "cuda"
            else None)
    engines = {}
    for b in manifest["buckets"]:
        start = time.perf_counter()
        with _memoized_type_hints():
            condition, step = (
                torch.export.load(os.path.join(path, b[k])).module()
                for k in ("condition", "step"))
        engine = ExportedEngine(condition, step, weights, ts, pool)
        engine.stats["load_s"] = time.perf_counter() - start
        engines[(b["B"], b["S"], b["T"])] = engine
    return manifest, engines
