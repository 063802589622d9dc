"""Build the port's CUDA sources into shared libraries and load them.

Each ``zipvoice_torch/csrc/<name>.cu`` exposes a plain C interface and is
compiled by ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the repository
root (listed in ``.gitignore``), once per content of the source and of the
headers it may include (``csrc/*.cuh``); the library is then
loaded with ``ctypes``.  Nothing here runs at import time.  The wrappers'
shared conventions live here too: the dtype codes of the C entry points and
the checks around a launch.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Sequence

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def kernel_sources() -> Sequence[str]:
    """Names of every CUDA source in the package (without ``.cu``)."""
    return sorted(
        f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
    )


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or PATH)")
    return found


def library_path(name: str) -> str:
    """The library's path, keyed by the source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    parts = [os.path.join(CSRC_DIR, name + ".cu")] + sorted(
        os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
        if f.endswith(".cuh")
    )
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in parts:
        with open(part, "rb") as f:
            digest.update(f.read())
    digest = digest.hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile the named sources that are not built yet, all ``nvcc``
    processes at once.  Returns {name: ptxas report}; the report (the
    ``-Xptxas -v`` register, shared-memory and spill lines) is also kept
    beside the library as ``<library>.log``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        so = library_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        with open(so + ".log", "w") as f:
            f.write(log)
        # atomic: a concurrent builder never sees half a library
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    reports = {}
    for name in names:
        log_path = library_path(name) + ".log"
        reports[name] = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                reports[name] = f.read()
    return reports


# the dtype argument of every C entry point in csrc/
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def untraced(t: torch.Tensor) -> bool:
    """True for a plain tensor while nothing traces (no ``torch.export``,
    ``torch.compile`` or other dispatch mode at work).  An operator's
    wrapper then calls the implementation itself: a call through
    ``torch.ops`` costs tens of Python frames of the dispatcher's custom-op
    layers, host time on a host-bound path.  A traced call goes through the
    operator, so that the program holds it."""
    return (not torch.compiler.is_compiling() and type(t) is torch.Tensor
            and not torch._C._len_torch_dispatch_stack())


def require_cuda(t: torch.Tensor) -> None:
    """A wrapper's guard: a tensor that is not on the CPU must be on CUDA."""
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


def raise_on(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error (its
    ``cudaGetLastError()`` after the launch)."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    build([name])
    return ctypes.CDLL(library_path(name))
