"""Compressed feature file IO backed by a native (C++) codec (the port's
copy of ``zipvoice_tpu/data/featio.py``).

File format (".fz"):
  magic b"FZ01" | int32 n_frames | int32 dim |
  float32 scales[n_frames] | int16 q[n_frames, dim]

The codec (``zipvoice_torch/native/featio.cpp``) quantizes each frame to
int16 with a per-frame scale, the role lilcom plays in the reference's
feature store, at ~2x compression over fp32 with ~1e-4 relative error.  The
shared library is compiled on first use with g++ into ``build/native/`` at
the repository root (listed in ``.gitignore``), keyed by the hash of the
source and the flags as ``kernels/_build.py`` keys its libraries, and bound
with ctypes.  A numpy codec writes the same format where no compiler is
found; ``codec()`` says which one runs.
"""

import ctypes
import hashlib
import logging
import os
import struct
import subprocess
import threading

import numpy as np

_MAGIC = b"FZ01"
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "featio.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "native")
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_lib_failed = False


def library_path() -> str:
    """The library's path, keyed by the source and the flags."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libfeatio_{digest.hexdigest()[:16]}.so")


def _load_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = library_path()
        try:
            if not os.path.exists(so):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                               check=True, capture_output=True)
                # atomic: a concurrent builder never sees half a library
                os.replace(tmp, so)
            lib = ctypes.cdll.LoadLibrary(so)
            i64, f32p, i16p = (
                ctypes.c_int64,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_int16),
            )
            lib.featio_encode_i16.argtypes = [f32p, i64, i64, i16p, f32p]
            lib.featio_decode_i16.argtypes = [i16p, f32p, i64, i64, f32p]
            _lib = lib
        except Exception as e:  # noqa: BLE001
            logging.warning(f"featio native build failed ({e}); numpy codec")
            _lib_failed = True
    return _lib


def codec() -> str:
    """"native" when the C++ library is built and loaded, else "numpy"."""
    return "native" if _load_lib() is not None else "numpy"


def encode(x: np.ndarray):
    """(n_frames, dim) float32 -> (q int16, scales float32)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, d = x.shape
    q = np.empty((n, d), np.int16)
    scales = np.empty((n,), np.float32)
    lib = _load_lib()
    if lib is not None:
        lib.featio_encode_i16(
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, d,
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return q, scales
    maxabs = np.abs(x).max(axis=1)
    scales[:] = np.where(maxabs > 0, maxabs / 32767.0, 1.0)
    q[:] = np.clip(
        np.round(x / scales[:, None]), -32768, 32767
    ).astype(np.int16)
    return q, scales


def decode(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    q = np.ascontiguousarray(q, dtype=np.int16)
    scales = np.ascontiguousarray(scales, dtype=np.float32)
    n, d = q.shape
    out = np.empty((n, d), np.float32)
    lib = _load_lib()
    if lib is not None:
        lib.featio_decode_i16(
            q.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, d,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out
    return q.astype(np.float32) * scales[:, None]


def save_feats(path: str, x: np.ndarray) -> None:
    q, scales = encode(x)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<ii", q.shape[0], q.shape[1]))
        f.write(scales.tobytes())
        f.write(q.tobytes())


def load_feats(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.read(4)
        assert magic == _MAGIC, f"bad feature file {path}"
        n, d = struct.unpack("<ii", f.read(8))
        scales = np.frombuffer(f.read(4 * n), np.float32)
        q = np.frombuffer(f.read(2 * n * d), np.int16).reshape(n, d)
    return decode(q, scales)
