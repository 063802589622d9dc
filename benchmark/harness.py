"""What every cell of the benchmark shares: finding a cell's configuration,
traffic and metrics by name, the run's environment, seeds, the check that
nothing of JAX was loaded, the device's description, the profiler's slice
and the result line."""

import importlib.util
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))

# whole top-level module names that no process of a run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "zipvoice_tpu")


class Cell:
    """One entry of ``BENCHMARK.json``'s workloads, with its configuration,
    its traffic mix and the metrics that apply to it, all read from the
    files that their names give."""

    def __init__(self, root: str, name: str):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            spec = json.load(f)
        self.root = root
        self.bench_dir = os.path.join(root, spec["paths"][0])
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; the benchmark has "
                             f"{sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in spec["configs"]}
        config_file = configs[self.entry["config"]]["file"]
        with open(os.path.join(root, config_file)) as f:
            self.config = json.load(f)
        with open(os.path.join(self.bench_dir, "traffic",
                               self.entry["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        self.end_to_end = [m for m in spec["end_to_end"] if self._applies(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._applies(m)]

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def driver(self):
        return load_file(os.path.join(self.bench_dir, "drivers",
                                      self.traffic["driver"] + ".py"))

    def read_metrics(self, metrics: List[dict], rec: dict) -> Dict[str, dict]:
        """{name: {value, unit}} of each metric whose reader
        (``metrics/<name>.py``'s ``read``) finds something in ``rec``."""
        out = {}
        for m in metrics:
            reader = load_file(os.path.join(self.bench_dir, "metrics",
                                            m["name"] + ".py"))
            value = reader.read(rec)
            if value is not None:
                out[m["name"]] = {"value": float(value), "unit": m["unit"]}
        return out


def load_file(path: str):
    """The module in ``path``, imported under a name of its own."""
    name = "bench_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def setup_env(root: str) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths, and keep libraries from loading JAX or TensorFlow by
    themselves."""
    build = os.path.join(root, "build")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(build, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    os.environ["USE_JAX"] = "0"


def pin_cpus(half: str = "upper") -> List[int]:
    """Pin this process to one half of the CPUs it may use (the upper or
    the lower), with at least one CPU: a host-bound run that the scheduler
    moves between all of a machine's cores reads up to tens of percent slow
    at random.  Returns the CPUs kept."""
    allowed = sorted(os.sched_getaffinity(0))
    mid = len(allowed) // 2
    keep = (allowed[mid:] if half == "upper" else allowed[:mid]) or allowed
    os.sched_setaffinity(0, keep)
    return keep


def host_clocks() -> dict:
    """The calling thread's CPU seconds and seconds spent waiting for a CPU
    (its run queue, from ``/proc/thread-self/schedstat``), and the
    machine's stolen seconds summed over its CPUs (``/proc/stat``): what
    tells a host that computes more slowly from one that does not let the
    process run."""
    out = {"cpu_s": time.thread_time(), "runq_s": 0.0, "steal_s": 0.0}
    try:
        with open("/proc/thread-self/schedstat") as f:
            out["runq_s"] = int(f.read().split()[1]) * 1e-9
        with open("/proc/stat") as f:
            fields = f.readline().split()
        out["steal_s"] = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def seed_for(seed: int, *keys) -> int:
    """A 32-bit seed of its own for each use of the run's seed."""
    words = [int(seed) & 0xFFFFFFFF, int(seed) >> 32]
    for k in keys:
        if isinstance(k, str):
            words.extend(k.encode())
        else:
            words.append(int(k) & 0xFFFFFFFF)
    return int(np.random.SeedSequence(words).generate_state(1)[0])


def forbidden_loaded() -> List[str]:
    """The forbidden top-level names among the loaded modules."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def device_info(torch, device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": 0}


def power_limit() -> str:
    """The first card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Profiled:
    """``torch.profiler`` over one slice of a run, marked by an annotation
    whose span is the slice; ``stop`` writes the trace and returns its
    summary (``summarize_trace``)."""

    def __init__(self, torch, path: str):
        self.torch = torch
        self.path = path
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.mark = None

    def start(self):
        self.prof.__enter__()
        self.mark = self.torch.profiler.record_function("bench_slice")
        self.mark.__enter__()
        return time.monotonic()

    def stop(self) -> dict:
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        try:
            return summarize_trace(self.path)
        finally:
            os.remove(self.path)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def _short(name: str) -> str:
    name = name.replace("(anonymous namespace)", "anon").split("(", 1)[0]
    if name.startswith("void "):
        name = name[5:]
    return name[:120]


def summarize_trace(path: str) -> dict:
    """From a chrome trace of a slice: the slice's seconds, the seconds in
    which some device operation ran (the union of their intervals inside
    the slice), every kernel's name, seconds and grid, the device
    operations that took the most time, and the longest idle gaps of the
    device, each named by the innermost host operation that was running
    where it began."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mark = [e for e in events if e.get("name") == "bench_slice"
            and e.get("cat") == "user_annotation"]
    if not mark:
        return {}
    s0 = float(mark[0]["ts"])
    s1 = s0 + float(mark[0]["dur"])
    dev = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e)
                  for e in events if e.get("cat") in DEVICE_CATS),
                 key=lambda x: x[:2])
    dev = [(max(a, s0), min(b, s1), e) for a, b, e in dev if b > s0 and a < s1]
    busy, gaps, cur0, cur1 = 0.0, [], None, None
    edge = s0
    for a, b, _ in dev:
        if cur1 is None or a > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            gaps.append((a - edge, edge))
            cur0, cur1 = a, b
        else:
            cur1 = max(cur1, b)
        edge = cur1
    if cur1 is not None:
        busy += cur1 - cur0
    gaps.append((s1 - edge, edge))
    by_name: Dict[str, float] = {}
    kernels = []
    for a, b, e in dev:
        name = _short(e.get("name", "?"))
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
        if e.get("cat") == "kernel":
            kernels.append((e.get("name", ""), (b - a) * 1e-6,
                            list(e.get("args", {}).get("grid", []))))
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e.get("name", "?")) for e in events
            if e.get("cat") in HOST_CATS and e.get("name") != "bench_slice"]
    idle = []
    for length, at in sorted(gaps, reverse=True)[:10]:
        inner = [h for h in host if h[0] <= at < h[1]]
        label = (min(inner, key=lambda h: h[1] - h[0])[2] if inner
                 else "no traced host operation")
        idle.append([_short(label), length * 1e-6])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (s1 - s0) * 1e-6, "busy_s": busy * 1e-6,
            "kernels": kernels, "device_ops": [[n, s] for n, s in top],
            "idle_gaps": idle}


def emit(cell: Cell, rec: dict, trace: bool, device: dict,
         checks: List[dict], correct: bool, attempted: int, failed: int):
    """Print each compared number beside its limit as the last lines of
    standard error, then the result line as the last line of standard
    output."""
    metrics = cell.read_metrics(cell.per_layer if trace else cell.end_to_end,
                                rec)
    compared = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                for c in checks}
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if trace and rec.get("trace"):
        line["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                             "idle_gaps": rec["trace"]["idle_gaps"]}
    if "setup_parts" in rec:
        line["setup_parts"] = rec["setup_parts"]
    line["compared"] = compared
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
