"""SAME-padded depthwise conv1d over time: the CUDA kernels and their plain
versions.

Two kernels, each behind a wrapper that launches it for CUDA tensors and
takes its plain PyTorch version (``*_ref``) only for CPU tensors, and that
counts its launches in ``<wrapper>.launches``:

- ``depthwise_conv1d`` replaces the TPU kernel
  ``zipvoice_tpu/ops/pallas_conv.py::_dwconv_kernel``;
- ``depthwise_conv1d_bwd`` replaces ``_dwconv_bwd_kernel``: dv, dw and db
  in one launch and one pass over v and g (dv from g's window, dw and db
  from v's window against g, per-block f32 partials of dw and db that the
  last block of each channel slice sums in a fixed order).

Both are in ``zipvoice_torch/csrc/depthwise_conv.cu``, whose header says
what bounds them on an H100 and how the design answers that.
``depthwise_conv1d_trainable`` joins them in a ``torch.autograd.Function``
(the JAX package's ``depthwise_conv1d_vjp``).

Layouts are the port's: activations (B, T, C) with channels contiguous, the
filter (C, k), which is the reference parameter ``depthwise_conv.weight``
(C, 1, k) viewed without its middle axis, and the bias (C,).
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from zipvoice_torch.kernels._build import (
    DTYPE_CODES,
    load_library,
    raise_on,
    require_cuda,
)

_SOURCE = "depthwise_conv"
# kernel sizes the source is built for (depthwise_conv.cu, ZV_DWCONV_SIZES)
KERNEL_SIZES = (3, 5, 7, 9, 15, 31)


def depthwise_conv1d_ref(v: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """Plain version of the forward: ``F.conv1d`` with ``groups=C`` and
    SAME padding in f32, rounded once to v's dtype.  v (B, T, C), w (C, k),
    b (C,) -> (B, T, C)."""
    C, k = w.shape
    out = F.conv1d(v.float().transpose(1, 2), w.float()[:, None, :],
                   b.float(), padding=k // 2, groups=C)
    return out.transpose(1, 2).to(v.dtype)


def depthwise_conv1d_bwd_ref(v: torch.Tensor, g: torch.Tensor,
                             w: torch.Tensor):
    """Plain version of the backward, in f32: (dv (B, T, C) in v's dtype,
    dw (C, k) and db (C,) in w's dtype), from the input v, the upstream
    gradient g (B, T, C) and the filter w (C, k)."""
    C, k = w.shape
    vt = v.float().transpose(1, 2)
    gt = g.float().transpose(1, 2)
    dv, dw, db = torch.ops.aten.convolution_backward(
        gt, vt, w.float()[:, None, :], [C], [1], [k // 2], [1], False, [0],
        C, [True, True, True],
    )
    return (dv.transpose(1, 2).to(v.dtype), dw[:, 0].to(w.dtype),
            db.to(w.dtype))


@functools.cache
def _kernel():
    lib = load_library(_SOURCE)
    fwd = lib.zv_depthwise_conv1d
    fwd.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p
    ]
    fwd.restype = ctypes.c_int
    bwd = lib.zv_depthwise_conv1d_bwd
    bwd.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p
    ]
    bwd.restype = ctypes.c_int
    scratch = lib.zv_depthwise_conv1d_bwd_scratch_floats
    scratch.argtypes = [ctypes.c_int] * 4
    scratch.restype = ctypes.c_longlong
    return fwd, bwd, scratch


# the backward's f32 scratch per (device, stream): its head holds the
# kernel's completion counters, which must be zero when it launches and which
# it leaves zero, so the scratch is zeroed once and kept (calls on one stream
# run in order); a larger shape replaces it with a larger zeroed one
_SCRATCH = {}


def _scratch(device, stream, floats):
    buf = _SCRATCH.get((device, stream))
    if buf is None or buf.numel() < floats:
        buf = torch.zeros((floats,), dtype=torch.float32, device=device)
        _SCRATCH[(device, stream)] = buf
    return buf


def _check(v, w, b=None, g=None):
    if v.dim() != 3 or w.dim() != 2:
        raise ValueError(f"want v (B, T, C) and w (C, k), got "
                         f"{tuple(v.shape)} and {tuple(w.shape)}")
    B, T, C = v.shape
    k = w.shape[1]
    if w.shape[0] != C:
        raise ValueError(f"w has {w.shape[0]} channels, v has {C}")
    if k % 2 == 0:
        raise ValueError(f"SAME padding needs an odd kernel size, got {k}")
    if k not in KERNEL_SIZES:
        raise ValueError(f"the kernel is built for k in {KERNEL_SIZES}, "
                         f"got {k}")
    if v.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {v.dtype}")
    for name, t, want in (("w", w, (C, k)), ("b", b, (C,)),
                          ("g", g, (B, T, C))):
        if t is None:
            continue
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{want}")
        if t.dtype != v.dtype or t.device != v.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, v is "
                             f"{v.dtype} on {v.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not v.is_contiguous():
        raise ValueError("v must be contiguous")
    if not 0 < B <= 65535 or T <= 0:
        raise ValueError(f"unsupported sizes B={B}, T={T}")


def depthwise_conv1d(v: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """SAME-padded depthwise conv over time plus bias, taps summed in f32,
    in v's dtype: v (B, T, C), w (C, k), b (C,) -> (B, T, C).  CUDA
    tensors (f32 or bf16, contiguous, one dtype, k in ``KERNEL_SIZES``) run
    the kernel; CPU tensors run the plain version."""
    if v.device.type == "cpu":
        return depthwise_conv1d_ref(v, w, b)
    require_cuda(v)
    _check(v, w, b=b)
    B, T, C = v.shape
    fwd, _, _ = _kernel()
    out = torch.empty_like(v)
    with torch.cuda.device(v.device):
        err = fwd(DTYPE_CODES[v.dtype], w.shape[1], v.data_ptr(),
                  w.data_ptr(), b.data_ptr(), out.data_ptr(), B, T, C,
                  torch.cuda.current_stream(v.device).cuda_stream)
    raise_on(err, "depthwise_conv1d")
    depthwise_conv1d.launches += 1
    return out


depthwise_conv1d.launches = 0


def depthwise_conv1d_bwd(v: torch.Tensor, g: torch.Tensor, w: torch.Tensor):
    """The backward: (dv (B, T, C), dw (C, k), db (C,)), all in the inputs'
    dtype, dw and db summed over batch and time in f32 in a fixed order (the
    same bits on every run).  CUDA tensors run the kernel; CPU tensors run
    the plain version."""
    if v.device.type == "cpu":
        return depthwise_conv1d_bwd_ref(v, g, w)
    require_cuda(v)
    _check(v, w, g=g)
    B, T, C = v.shape
    k = w.shape[1]
    _, bwd, scratch_floats = _kernel()
    dv = torch.empty_like(v)
    dw = torch.empty_like(w)
    db = torch.empty((C,), dtype=w.dtype, device=w.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    scratch = _scratch(v.device, stream, scratch_floats(B, T, C, k))
    with torch.cuda.device(v.device):
        err = bwd(DTYPE_CODES[v.dtype], k, v.data_ptr(), g.data_ptr(),
                  w.data_ptr(), dv.data_ptr(), dw.data_ptr(), db.data_ptr(),
                  scratch.data_ptr(), B, T, C, stream)
    raise_on(err, "depthwise_conv1d_bwd")
    depthwise_conv1d_bwd.launches += 1
    return dv, dw, db


depthwise_conv1d_bwd.launches = 0


class _TrainableConv(torch.autograd.Function):
    """The forward and backward kernels as one differentiable op."""

    @staticmethod
    def forward(ctx, v, w, b):
        ctx.save_for_backward(v, w)
        return depthwise_conv1d(v, w, b)

    @staticmethod
    def backward(ctx, g):
        v, w = ctx.saved_tensors
        return depthwise_conv1d_bwd(v, g.to(v.dtype).contiguous(), w)


def depthwise_conv1d_trainable(v: torch.Tensor, w: torch.Tensor,
                               b: torch.Tensor) -> torch.Tensor:
    """Differentiable ``depthwise_conv1d``: its gradients come from
    ``depthwise_conv1d_bwd`` (on the CPU from their plain versions)."""
    return _TrainableConv.apply(v, w, b)
