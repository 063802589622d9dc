"""Relative-position attention weights and their application: the CUDA
kernels and their plain versions.

Five kernels, each behind a wrapper that launches it for CUDA tensors and
takes its plain PyTorch version (``*_ref``) only for CPU tensors, and that
counts its launches in ``<wrapper>.launches``:

- ``rel_pos_attention_weights`` (inference) replaces the TPU kernel
  ``zipvoice_tpu/ops/pallas_attention.py::_attn_weights_kernel``;
- ``rel_pos_attention_weights_train`` replaces ``_attn_weights_train_kernel``:
  the same weights plus the largest |pre-mask score|, which gates the score
  penalty in the backward;
- ``rel_pos_attention_weights_bwd`` replaces ``_attn_weights_bwd_kernel``:
  dq, dk, dp and dpe in f32;
- ``rel_pos_attention_weights_nonlin`` replaces
  ``_attn_weights_nonlin_kernel``: the inference weights plus
  NonlinAttention's application of head 0's weights, in one pass;
- ``attention_apply`` replaces ``_attn_apply_kernel``: SelfAttention's
  weights @ values.

The first two are builds of ``zipvoice_torch/csrc/rel_pos_attention.cu``,
the third is ``zipvoice_torch/csrc/rel_pos_attention_bwd.cu``, the fourth
``zipvoice_torch/csrc/rel_pos_attention_nonlin.cu`` and the fifth
``zipvoice_torch/csrc/attention_apply.cu``.  Each has a tensor-core build
for bf16 and a CUDA-core build for f32; the bf16 builds of the inference,
training and fused weights run one copy of the weights code
(``csrc/rel_pos_sweeps.cuh``).
Each source's header says what bounds it on an H100 and how its design
answers that.
``rel_pos_attention_weights_trainable`` joins the training pair in a
``torch.autograd.Function``.

The three inference wrappers (the weights, the fused weights and the
application) are also operators registered with ``torch.library``
(``zipvoice::<wrapper>``): the CUDA implementation launches the kernel,
the CPU implementation is the plain version, and a fake implementation
gives the output shapes, so that ``torch.export`` traces them into a
program (``serving/aot.py``) and a CUDA graph captures their launches.
Outside tracing a wrapper calls the implementation itself
(``_build.untraced``).
"""

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from zipvoice_torch.kernels._build import (
    DTYPE_CODES,
    load_library,
    raise_on,
    require_cuda,
    untraced,
)

_SOURCE = "rel_pos_attention"
_NONLIN_SOURCE = "rel_pos_attention_nonlin"
_BWD_SOURCE = "rel_pos_attention_bwd"
_APPLY_SOURCE = "attention_apply"
# query head dims the kernel is built for (rel_pos_attention.cu, dispatch_qd)
_HEAD_DIMS = (8, 32)
_POS_HEAD_DIM = 4
# NonlinAttention hidden widths the nonlin kernel is built for
# (rel_pos_attention_nonlin.cu, zv_rel_pos_attention_weights_nonlin): the
# fm_decoder's 384, the text encoder's 144, the tests' 48
_HIDDEN_DIMS = (48, 144, 384)
# value head dim the application kernel is built for (attention_apply.cu)
_VALUE_HEAD_DIM = 12
# shared memory one block may use on Hopper (227 KB)
_MAX_SMEM = 232448


def _scores_ref(q, k, p, pe):
    """f32 pre-mask scores q_i.k_j + p_i.pe[j - i + T - 1], (B, h, T, T)."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return scores + _skew(torch.einsum("bhtd,hnd->bhtn", p.float(),
                                       pe.float()))


def _skew(pos: torch.Tensor) -> torch.Tensor:
    """(B, h, T, 2T-1) relative scores -> (B, h, T, T) absolute:
    out[t, s] = pos[t, s - t + T - 1]."""
    B, h, T, _ = pos.shape
    ar = torch.arange(T, device=pos.device)
    rel = (ar[None, :] - ar[:, None] + (T - 1)).expand(B, h, T, T)
    return torch.gather(pos, -1, rel)


def _unskew(ds: torch.Tensor) -> torch.Tensor:
    """Adjoint of ``_skew``: (B, h, T, T) -> (B, h, T, 2T-1) with
    out[t, n] = ds[t, t + n - (T-1)], zero outside."""
    B, h, T, _ = ds.shape
    w2 = 3 * T - 2
    flat = F.pad(ds, (T - 1, T - 1)).reshape(B, h, T * w2)
    flat = F.pad(flat, (0, T))
    return flat[..., : T * (w2 + 1)].reshape(B, h, T, w2 + 1)[..., : 2 * T - 1]


# the failsafe score penalty: d/ds [penalty * relu(|s| - limit)]
SCORE_LIMIT = 25.0
SCORE_PENALTY = 1.0e-04


def rel_pos_attention_weights_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    p: torch.Tensor,
    pe: torch.Tensor,
    key_padding_mask: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same inputs and output,
    f32 scores and softmax, masked keys filled with -1000, output in q's
    dtype.  q, k: (B, h, T, qd); p: (B, h, T, pd); pe: (h, 2T-1, pd);
    key_padding_mask: (B, T) bool, True = padded key."""
    scores = _scores_ref(q, k, p, pe)
    scores = scores.masked_fill(key_padding_mask[:, None, None, :], -1000.0)
    return torch.softmax(scores, dim=-1).to(q.dtype)


def rel_pos_attention_weights_train_ref(q, k, p, pe, key_padding_mask):
    """Plain version of the training forward: (weights in q's dtype, the
    largest |pre-mask score| as an f32 device scalar)."""
    scores = _scores_ref(q, k, p, pe)
    smax = scores.abs().amax()
    scores = scores.masked_fill(key_padding_mask[:, None, None, :], -1000.0)
    return torch.softmax(scores, dim=-1).to(q.dtype), smax


def rel_pos_attention_weights_nonlin_ref(q, k, p, pe, key_padding_mask, nv):
    """Plain version of the nonlin kernel: (weights as
    ``rel_pos_attention_weights_ref`` gives them, na (B, T, hid) in q's
    dtype), na = weights[:, 0] @ nv with the weights rounded to q's dtype
    first and the product summed in f32."""
    w = rel_pos_attention_weights_ref(q, k, p, pe, key_padding_mask)
    return w, torch.matmul(w[:, 0].float(), nv.float()).to(q.dtype)


def attention_apply_ref(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of the application kernel: w (B, h, T, T) @ v
    (B, h, T, vd), summed in f32, in v's dtype."""
    return torch.matmul(w.float(), v.float()).to(v.dtype)


def rel_pos_attention_weights_bwd_ref(q, k, p, pe, g, w, coin_live):
    """Plain version of the backward, in f32: the softmax VJP, the score
    penalty gated by ``coin_live`` (an f32 0/1 device scalar) on the
    recomputed scores, and the four input gradients (dq, dk, dp, dpe).

    Like the JAX package's ``_trainable_bwd`` (and its kernel) it does not
    mask ds: on a fully masked row (uniform weights 1/T under the -1000
    fill) gradient reaches q and k, where autodiff of the plain skew path
    sends none.  Training batches hold no such row."""
    g32, w32 = g.float(), w.float()
    ds = w32 * (g32 - torch.sum(g32 * w32, dim=-1, keepdim=True))
    # multiplied by the device flag instead of branching on it: no sync
    scores = _scores_ref(q, k, p, pe)
    ds = ds + coin_live * SCORE_PENALTY * torch.sign(scores) * (
        scores.abs() > SCORE_LIMIT
    ).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    drel = _unskew(ds)
    dp = torch.einsum("bhtn,hnd->bhtd", drel, pe.float())
    dpe = torch.einsum("bhtn,bhtd->hnd", drel, p.float())
    return dq, dk, dp, dpe


@functools.cache
def _kernel():
    lib = load_library(_SOURCE)
    ptrs = [ctypes.c_void_p]
    fn = lib.zv_rel_pos_attention_weights
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + ptrs * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    train = lib.zv_rel_pos_attention_weights_train
    train.argtypes = [ctypes.c_int, ctypes.c_int] + ptrs * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p
    ]
    train.restype = ctypes.c_int
    smem = lib.zv_rel_pos_attention_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    rows = lib.zv_rel_pos_attention_rows_per_block
    rows.argtypes = [ctypes.c_int]
    rows.restype = ctypes.c_int
    return fn, train, smem, rows


@functools.cache
def _nonlin_kernel():
    lib = load_library(_NONLIN_SOURCE)
    fn = lib.zv_rel_pos_attention_weights_nonlin
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    smem = lib.zv_rel_pos_attention_nonlin_smem_bytes
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_longlong
    return fn, smem


@functools.cache
def _apply_kernel():
    lib = load_library(_APPLY_SOURCE)
    fn = lib.zv_attention_apply
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    smem = lib.zv_attention_apply_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    return fn, smem


@functools.cache
def _bwd_kernel():
    lib = load_library(_BWD_SOURCE)
    fn = lib.zv_rel_pos_attention_bwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 12 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    scratch = lib.zv_rel_pos_attention_bwd_scratch_floats
    scratch.argtypes = [ctypes.c_int] * 4
    scratch.restype = ctypes.c_longlong
    smem = lib.zv_rel_pos_attention_bwd_smem_bytes
    smem.argtypes = [ctypes.c_int] * 3
    smem.restype = ctypes.c_longlong
    return fn, scratch, smem


def _check(q, k, p, pe, key_padding_mask=None, g=None, w=None, nv=None):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, h, T, qd), got {tuple(q.shape)}")
    B, h, T, qd = q.shape
    pd = p.shape[-1]
    hid = nv.shape[-1] if nv is not None else 0
    shapes = {
        "k": (k, (B, h, T, qd)),
        "p": (p, (B, h, T, pd)),
        "pe": (pe, (h, 2 * T - 1, pd)),
        "key_padding_mask": (key_padding_mask, (B, T)),
        "g": (g, (B, h, T, T)),
        "w": (w, (B, h, T, T)),
        "nv": (nv, (B, T, hid)),
    }
    shapes = {n: v for n, v in shapes.items() if v[0] is not None}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {want}")
    for name, (t, _) in [("q", (q, None))] + list(shapes.items()):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t is not key_padding_mask and t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}")
    if key_padding_mask is not None and key_padding_mask.dtype != torch.bool:
        raise ValueError("key_padding_mask must be bool")
    if qd not in _HEAD_DIMS or pd != _POS_HEAD_DIM:
        raise ValueError(
            f"kernel takes qd in {_HEAD_DIMS} and pd={_POS_HEAD_DIM}, "
            f"got qd={qd}, pd={pd}"
        )
    if nv is not None and hid not in _HIDDEN_DIMS:
        raise ValueError(f"the nonlin kernel takes hid in {_HIDDEN_DIMS}, "
                         f"got {hid}")
    if not 0 < B * h <= 65535 or T <= 0:
        raise ValueError(f"unsupported sizes B*h={B * h}, T={T}")
    for name, t in (("q", q), ("k", k), ("nv", nv)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _weights_cuda(q: torch.Tensor, k: torch.Tensor, p: torch.Tensor,
                  pe: torch.Tensor, key_padding_mask: torch.Tensor
                  ) -> torch.Tensor:
    """The operator's CUDA implementation: the hand-written kernel."""
    require_cuda(q)
    _check(q, k, p, pe, key_padding_mask)
    if q.dtype == torch.bfloat16 and (p.data_ptr() % 8 or pe.data_ptr() % 8):
        raise ValueError("p and pe must be 8-byte aligned")
    B, h, T, qd = q.shape
    fn, _, smem_bytes, _ = _kernel()
    if smem_bytes(DTYPE_CODES[q.dtype], qd, T) > _MAX_SMEM:
        raise ValueError(f"T={T} needs more shared memory than a block has")
    out = torch.empty((B, h, T, T), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(
            DTYPE_CODES[q.dtype], qd, q.data_ptr(), k.data_ptr(),
            p.data_ptr(), pe.data_ptr(), key_padding_mask.data_ptr(),
            out.data_ptr(), B, h, T,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    raise_on(err, "rel_pos_attention_weights")
    rel_pos_attention_weights.launches += 1
    return out


_weights_op = torch.library.custom_op(
    "zipvoice::rel_pos_attention_weights", _weights_cuda, mutates_args=(),
    device_types="cuda")
_weights_op.register_kernel("cpu")(rel_pos_attention_weights_ref)


@_weights_op.register_fake
def _(q, k, p, pe, key_padding_mask):
    B, h, T, _ = q.shape
    return q.new_empty((B, h, T, T))


def rel_pos_attention_weights(
    q: torch.Tensor,
    k: torch.Tensor,
    p: torch.Tensor,
    pe: torch.Tensor,
    key_padding_mask: torch.Tensor,
) -> torch.Tensor:
    """softmax_j(q_i.k_j + p_i.pe[j-i+T-1]; masked keys -> -1000), shape
    (B, h, T, T) in q's dtype (traced, through the operator
    ``zipvoice::rel_pos_attention_weights``).  CUDA tensors (f32 or bf16,
    contiguous) run the hand-written kernel (bf16 on the tensor cores); CPU
    tensors run the plain version."""
    if not untraced(q):
        return _weights_op(q, k, p, pe, key_padding_mask)
    if q.device.type == "cpu":
        return rel_pos_attention_weights_ref(q, k, p, pe, key_padding_mask)
    return _weights_cuda(q, k, p, pe, key_padding_mask)


rel_pos_attention_weights.launches = 0


def rel_pos_attention_weights_train(q, k, p, pe, key_padding_mask):
    """The training forward: (weights (B, h, T, T) in q's dtype, the
    largest |pre-mask score| as an f32 device scalar).  CUDA tensors run
    the kernel's training build (bf16 on the tensor cores, the inference
    build's weights bit for bit), which also writes each block's largest
    |score|; CPU tensors run the plain version."""
    if q.device.type == "cpu":
        return rel_pos_attention_weights_train_ref(q, k, p, pe,
                                                   key_padding_mask)
    require_cuda(q)
    _check(q, k, p, pe, key_padding_mask)
    if q.dtype == torch.bfloat16 and (p.data_ptr() % 8 or pe.data_ptr() % 8):
        raise ValueError("p and pe must be 8-byte aligned")
    B, h, T, qd = q.shape
    _, fn, smem_bytes, rows_per_block = _kernel()
    if smem_bytes(DTYPE_CODES[q.dtype], qd, T) > _MAX_SMEM:
        raise ValueError(f"T={T} needs more shared memory than a block has")
    rows = rows_per_block(DTYPE_CODES[q.dtype])
    out = torch.empty((B, h, T, T), dtype=q.dtype, device=q.device)
    block_max = torch.empty((B * h, (T + rows - 1) // rows),
                            dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(
            DTYPE_CODES[q.dtype], qd, q.data_ptr(), k.data_ptr(),
            p.data_ptr(), pe.data_ptr(), key_padding_mask.data_ptr(),
            out.data_ptr(), block_max.data_ptr(), B, h, T,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    raise_on(err, "rel_pos_attention_weights_train")
    rel_pos_attention_weights_train.launches += 1
    return out, block_max.amax()


rel_pos_attention_weights_train.launches = 0


def _nonlin_cuda(q: torch.Tensor, k: torch.Tensor, p: torch.Tensor,
                 pe: torch.Tensor, key_padding_mask: torch.Tensor,
                 nv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator's CUDA implementation: the hand-written kernel."""
    require_cuda(q)
    _check(q, k, p, pe, key_padding_mask, nv=nv)
    if p.data_ptr() % 8 or pe.data_ptr() % 8:
        raise ValueError("p and pe must be 8-byte aligned")
    B, h, T, qd = q.shape
    hid = nv.shape[-1]
    fn, smem_bytes = _nonlin_kernel()
    if smem_bytes(DTYPE_CODES[q.dtype], qd, T, hid) > _MAX_SMEM:
        raise ValueError(f"T={T} needs more shared memory than a block has")
    out = torch.empty((B, h, T, T), dtype=q.dtype, device=q.device)
    na = torch.empty((B, T, hid), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(
            DTYPE_CODES[q.dtype], qd, q.data_ptr(), k.data_ptr(),
            p.data_ptr(), pe.data_ptr(), key_padding_mask.data_ptr(),
            out.data_ptr(), nv.data_ptr(), na.data_ptr(), hid, B, h, T,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    raise_on(err, "rel_pos_attention_weights_nonlin")
    rel_pos_attention_weights_nonlin.launches += 1
    return out, na


_nonlin_op = torch.library.custom_op(
    "zipvoice::rel_pos_attention_weights_nonlin", _nonlin_cuda,
    mutates_args=(), device_types="cuda")
_nonlin_op.register_kernel("cpu")(rel_pos_attention_weights_nonlin_ref)


@_nonlin_op.register_fake
def _(q, k, p, pe, key_padding_mask, nv):
    B, h, T, _ = q.shape
    return q.new_empty((B, h, T, T)), q.new_empty((B, T, nv.shape[-1]))


def rel_pos_attention_weights_nonlin(q, k, p, pe, key_padding_mask, nv):
    """The weights (B, h, T, T) as ``rel_pos_attention_weights`` gives
    them, and na = weights[:, 0] @ nv (B, T, hid), both in q's dtype; nv is
    NonlinAttention's gated values (B, T, hid) in q's dtype (traced,
    through the operator ``zipvoice::rel_pos_attention_weights_nonlin``).
    CUDA tensors run the kernel (``csrc/rel_pos_attention_nonlin.cu``),
    which computes both in one pass; CPU tensors run the plain version."""
    if not untraced(q):
        return _nonlin_op(q, k, p, pe, key_padding_mask, nv)
    if q.device.type == "cpu":
        return rel_pos_attention_weights_nonlin_ref(q, k, p, pe,
                                                    key_padding_mask, nv)
    return _nonlin_cuda(q, k, p, pe, key_padding_mask, nv)


rel_pos_attention_weights_nonlin.launches = 0


def _apply_cuda(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The operator's CUDA implementation: the hand-written kernel."""
    require_cuda(w)
    if w.dim() != 4 or w.shape[-1] != w.shape[-2]:
        raise ValueError(f"w must be (B, h, T, T), got {tuple(w.shape)}")
    B, h, T, _ = w.shape
    vd = v.shape[-1]
    if tuple(v.shape) != (B, h, T, vd):
        raise ValueError(f"v has shape {tuple(v.shape)}, want (B, h, T, vd) "
                         f"= {(B, h, T, vd)}")
    if v.device != w.device or v.dtype != w.dtype:
        raise ValueError(f"v is {v.dtype} on {v.device}, w {w.dtype} on "
                         f"{w.device}")
    if w.dtype not in DTYPE_CODES:
        raise ValueError(f"unsupported dtype {w.dtype}")
    if not (w.is_contiguous() and v.is_contiguous()):
        raise ValueError("w and v must be contiguous")
    if vd != _VALUE_HEAD_DIM:
        raise ValueError(f"the kernel takes vd={_VALUE_HEAD_DIM}, got {vd}")
    if not 0 < B * h <= 65535 or w.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"unsupported B*h={B * h} or unaligned w or v")
    fn, smem_bytes = _apply_kernel()
    if smem_bytes(DTYPE_CODES[w.dtype], vd, T) > _MAX_SMEM:
        raise ValueError(f"T={T} needs more shared memory than a block has")
    out = torch.empty((B, h, T, vd), dtype=v.dtype, device=v.device)
    with torch.cuda.device(w.device):
        err = fn(DTYPE_CODES[w.dtype], vd, w.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, h, T,
                 torch.cuda.current_stream(w.device).cuda_stream)
    raise_on(err, "attention_apply")
    attention_apply.launches += 1
    return out


_apply_op = torch.library.custom_op(
    "zipvoice::attention_apply", _apply_cuda, mutates_args=(),
    device_types="cuda")
_apply_op.register_kernel("cpu")(attention_apply_ref)


@_apply_op.register_fake
def _(w, v):
    return v.new_empty(v.shape)


def attention_apply(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w (B, h, T, T) @ v (B, h, T, vd), summed in f32, in v's dtype
    (traced, through the operator ``zipvoice::attention_apply``).  CUDA
    tensors (f32 or bf16, contiguous, one dtype, vd = 12) run the kernel
    (``csrc/attention_apply.cu``); CPU tensors the plain version."""
    if not untraced(w):
        return _apply_op(w, v)
    if w.device.type == "cpu":
        return attention_apply_ref(w, v)
    return _apply_cuda(w, v)


attention_apply.launches = 0


def rel_pos_attention_weights_bwd(q, k, p, pe, g, w, coin_live):
    """The backward of the training pair: (dq, dk, dp, dpe) in f32 from the
    upstream gradient ``g`` and the saved weights ``w`` (both (B, h, T, T)
    in q's dtype) and ``coin_live``, an f32 0/1 device scalar that turns
    the score penalty on.  CUDA tensors run the kernel
    (``csrc/rel_pos_attention_bwd.cu``; bf16 on the tensor cores); CPU
    tensors the plain version."""
    if q.device.type == "cpu":
        return rel_pos_attention_weights_bwd_ref(q, k, p, pe, g, w,
                                                 coin_live)
    require_cuda(q)
    _check(q, k, p, pe, g=g, w=w)
    if (coin_live.device != q.device or coin_live.dtype != torch.float32
            or coin_live.numel() != 1):
        raise ValueError("coin_live must be one f32 value on q's device")
    if q.dtype == torch.bfloat16 and (
            p.data_ptr() % 8 or pe.data_ptr() % 8 or g.data_ptr() % 16
            or w.data_ptr() % 16):
        raise ValueError("p and pe must be 8-byte aligned, g and w 16-byte")
    B, h, T, qd = q.shape
    pd = p.shape[-1]
    code = DTYPE_CODES[q.dtype]
    fn, scratch_floats, smem_bytes = _bwd_kernel()
    if smem_bytes(code, qd, T) > _MAX_SMEM:
        raise ValueError(f"T={T} needs more shared memory than a block has")
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((B, h, T, qd), **f32)
    dk = torch.empty((B, h, T, qd), **f32)
    dp = torch.empty((B, h, T, pd), **f32)
    dpe = torch.empty((h, 2 * T - 1, pd), **f32)
    scratch = torch.empty((scratch_floats(code, B, h, T),), **f32)
    with torch.cuda.device(q.device):
        err = fn(
            code, qd, q.data_ptr(), k.data_ptr(),
            p.data_ptr(), pe.data_ptr(), g.data_ptr(), w.data_ptr(),
            coin_live.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dp.data_ptr(), dpe.data_ptr(), scratch.data_ptr(), B, h, T,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    raise_on(err, "rel_pos_attention_weights_bwd")
    rel_pos_attention_weights_bwd.launches += 1
    return dq, dk, dp, dpe


rel_pos_attention_weights_bwd.launches = 0


class _TrainableWeights(torch.autograd.Function):
    """The training pair as one differentiable op (the JAX package's
    ``rel_pos_attention_weights_trainable`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, p, pe, key_padding_mask, penalty_coin):
        w, smax = rel_pos_attention_weights_train(q, k, p, pe,
                                                  key_padding_mask)
        ctx.save_for_backward(q, k, p, pe, w, smax)
        ctx.penalty_coin = penalty_coin
        return w

    @staticmethod
    def backward(ctx, g):
        q, k, p, pe, w, smax = ctx.saved_tensors
        # the penalty's gradient is zero unless the coin landed and some
        # |score| passed the limit; the kernel reads this flag on the device
        if ctx.penalty_coin:
            coin_live = (smax > SCORE_LIMIT).float()
        else:
            coin_live = torch.zeros((), dtype=torch.float32, device=q.device)
        dq, dk, dp, dpe = rel_pos_attention_weights_bwd(
            q, k, p, pe, g.to(w.dtype).contiguous(), w, coin_live
        )
        return (dq.to(q.dtype), dk.to(k.dtype), dp.to(p.dtype),
                dpe.to(pe.dtype), None, None)


def rel_pos_attention_weights_trainable(
    q: torch.Tensor, k: torch.Tensor, p: torch.Tensor, pe: torch.Tensor,
    key_padding_mask: torch.Tensor, penalty_coin: bool,
) -> torch.Tensor:
    """Differentiable attention weights (B, h, T, T) in q's dtype: the
    training forward and its backward.  ``penalty_coin`` (a host bool,
    drawn by the caller with probability 0.1) arms the failsafe score
    penalty, which then fires only where the forward saw |score| > 25."""
    return _TrainableWeights.apply(q, k, p, pe, key_padding_mask,
                                   bool(penalty_coin))
