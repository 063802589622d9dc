"""The port's CUDA kernels against their plain versions, on a card.

These tests skip without CUDA.  They import neither JAX nor this
directory's conftest, so that on a GPU machine without JAX they run with

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from zipvoice_torch.kernels.depthwise_conv import (
    depthwise_conv1d,
    depthwise_conv1d_bwd,
    depthwise_conv1d_bwd_ref,
    depthwise_conv1d_ref,
)
from zipvoice_torch.kernels.rel_pos_attention import (
    attention_apply,
    attention_apply_ref,
    rel_pos_attention_weights,
    rel_pos_attention_weights_bwd,
    rel_pos_attention_weights_bwd_ref,
    rel_pos_attention_weights_nonlin,
    rel_pos_attention_weights_nonlin_ref,
    rel_pos_attention_weights_ref,
    rel_pos_attention_weights_train,
    rel_pos_attention_weights_train_ref,
)
from zipvoice_torch.models.zipformer import (
    ConvolutionModule,
    RelPosAttentionWeights,
    TrainGenerators,
    ZipformerEncoderLayer,
    compact_rel_pos_encoding,
    set_attention_kernel,
    set_conv_kernel,
    set_kernel_config,
)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(B, h, T, qd, pd, dtype, seed, scale=1.0):
    """Row 0 unpadded, row 1 with padded keys, row 2 fully masked; q and k
    scaled by ``scale`` (2 puts many |scores| past the penalty's 25)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g, device="cuda")
                ).to(dtype)

    lens = torch.tensor([T, T - T // 3, 0] + [T // 2] * (B - 3),
                        device="cuda")
    mask = torch.arange(T, device="cuda")[None, :] >= lens[:, None]
    return (randn(B, h, T, qd, scale=scale), randn(B, h, T, qd, scale=scale),
            randn(B, h, T, pd, scale=0.3), randn(h, 2 * T - 1, pd), mask)


def _assert_matches(got, want):
    """Element by element: both sides take an f32 softmax and round once
    to the output dtype, so bf16 may differ by one rounding (2^-7 of the
    weight) and f32 by a few f32 roundings (2e-6 absolute)."""
    assert got.dtype == want.dtype
    if got.dtype == torch.float32:
        bound = 2e-6
    else:
        bound = 2.0 ** -7 * want.float().abs() + 1e-6
    diff = (got.float() - want.float()).abs()
    assert (diff <= bound).all(), diff.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,qd", [(37, 8), (63, 32), (64, 32), (65, 32),
                                  (640, 32), (1029, 32), (1279, 32),
                                  (3072, 32)])
def test_rel_pos_attention_kernel_matches_plain(dtype, T, qd):
    """Ragged T around the bf16 build's 64-row tiles and 128-key chunks
    (63, 65), T no multiple of 8 (37, 63, 65, 1029, 1279: the weights'
    rows are then not 16-byte aligned), padded keys, and a fully masked
    sequence whose rows stay uniform at 1/T."""
    _cuda()
    args = _inputs(4, 4, T, qd, 4, dtype, seed=T)
    before = rel_pos_attention_weights.launches
    got = rel_pos_attention_weights(*args)
    torch.cuda.synchronize()
    assert rel_pos_attention_weights.launches == before + 1
    want = rel_pos_attention_weights_ref(*args)
    assert got.dtype == dtype and got.is_cuda
    _assert_matches(got, want)
    # the fully masked row is finite and uniform
    _assert_matches(got[2], torch.full_like(got[2], 1.0 / T))


@pytest.mark.gpu
def test_module_kernel_path_matches_plain_path():
    """RelPosAttentionWeights in f32 on the card: the gated kernel path
    and the skew path agree."""
    dev = _cuda()
    T, D = 700, 64
    torch.manual_seed(0)
    mod = RelPosAttentionWeights(D, 48, 4, 32, 4).to(dev)
    x = torch.randn(2, T, D, device=dev)
    mask = torch.zeros(2, T, dtype=torch.bool, device=dev)
    mask[1, -100:] = True
    pos = compact_rel_pos_encoding(T, 48, device=dev)
    with torch.no_grad():
        before = rel_pos_attention_weights.launches
        got = mod(x, pos, mask)
        assert rel_pos_attention_weights.launches == before + 1
        set_attention_kernel(mod, False)
        want = mod(x, pos, mask)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("qd,dtype", [(8, torch.float16),
                                      (16, torch.bfloat16)])
def test_cuda_tensor_never_takes_plain_version(qd, dtype):
    """A CUDA tensor the kernel does not take (a dtype or a head dim it is
    not built for) raises; it does not fall back to the plain version."""
    _cuda()
    args = _inputs(3, 4, 64, qd, 4, dtype, seed=0)
    with pytest.raises(ValueError):
        rel_pos_attention_weights(*args)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,qd", [(37, 8), (63, 32), (64, 32), (65, 32),
                                  (640, 32), (1029, 32)])
def test_train_forward_kernel_matches_plain(dtype, T, qd):
    """The training build: the same weights as the plain version and, bit
    for bit, as the inference build (each dtype's two builds share one
    code path for the weights), and its largest |pre-mask score| equal to
    the plain one up to the rounding of a sum taken in another order (1e-6
    of it).  Ragged T around the bf16 build's 64-row blocks (63, 65),
    padded keys and a fully masked sequence."""
    _cuda()
    args = _inputs(4, 4, T, qd, 4, dtype, seed=T, scale=2.0)
    before = rel_pos_attention_weights_train.launches
    got, smax = rel_pos_attention_weights_train(*args)
    torch.cuda.synchronize()
    assert rel_pos_attention_weights_train.launches == before + 1
    want, want_smax = rel_pos_attention_weights_train_ref(*args)
    _assert_matches(got, want)
    assert torch.equal(got, rel_pos_attention_weights(*args))
    assert smax.dtype == torch.float32 and smax.shape == ()
    assert abs(smax.item() - want_smax.item()) <= 1e-6 * want_smax.item()


def _assert_grads_close(got, want):
    """f32 sums of the same products in another order: within 1e-4 of
    the tensor's largest |value|."""
    assert got.dtype == torch.float32 and got.shape == want.shape
    bound = 1e-4 * want.abs().max().item()
    assert (got - want).abs().max().item() <= bound


@pytest.mark.gpu
@pytest.mark.parametrize("penalty", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,qd", [(37, 8), (63, 32), (64, 32), (65, 32),
                                  (700, 32), (1029, 32), (2560, 32)])
def test_bwd_kernel_matches_plain(dtype, T, qd, penalty):
    """dq, dk, dp and dpe of the backward kernel against the plain
    backward, with the penalty off and on (scores past 25): ragged T
    around the bf16 build's 64-row and 64-key tiles (63, 65) and 128-key
    chunks, T no multiple of 8 (37, 63, 65, 1029: g and w rows not 16-byte
    aligned), T=2560 (the largest level phase 5 of chip_smoke.py runs),
    padded keys and a fully masked sequence (uniform weights)."""
    _cuda()
    q, k, p, pe, mask = _inputs(3, 4, T, qd, 4, dtype, seed=T + 1,
                                scale=2.0 if penalty else 1.0)
    w = rel_pos_attention_weights_ref(q, k, p, pe, mask)
    g = torch.randn(w.shape, device="cuda").to(dtype)
    coin = torch.tensor(float(penalty), device="cuda")
    before = rel_pos_attention_weights_bwd.launches
    got = rel_pos_attention_weights_bwd(q, k, p, pe, g, w, coin)
    torch.cuda.synchronize()
    assert rel_pos_attention_weights_bwd.launches == before + 1
    want = rel_pos_attention_weights_bwd_ref(q, k, p, pe, g, w, coin)
    for a, b in zip(got, want):
        _assert_grads_close(a, b)
    if penalty:
        off = rel_pos_attention_weights_bwd_ref(q, k, p, pe, g, w,
                                                torch.zeros_like(coin))
        assert (want[0] - off[0]).abs().max().item() > 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("penalty", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_kernel_same_bits_each_run(dtype, penalty):
    """No atomics: two runs of the backward give the same bits."""
    _cuda()
    q, k, p, pe, mask = _inputs(3, 4, 1029, 32, 4, dtype, seed=5,
                                scale=2.0 if penalty else 1.0)
    w = rel_pos_attention_weights_ref(q, k, p, pe, mask)
    g = torch.randn(w.shape, device="cuda").to(dtype)
    coin = torch.tensor(float(penalty), device="cuda")
    first = rel_pos_attention_weights_bwd(q, k, p, pe, g, w, coin)
    again = rel_pos_attention_weights_bwd(q, k, p, pe, g, w, coin)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_kernel_cancels_a_row_constant(dtype):
    """The softmax VJP cancels a constant added to a row of g when the
    row's weights sum to 1: with weights k/1024 (k <= 255 integers summing
    to 1024 a row) and g0 on a 1/16 grid in [-2, 2], both exact in bf16,
    as is g0 + 10, the kernel on g0 + 10 stays within the backward's
    tolerance (1e-4 of each output's largest |value|) of the kernel on g0,
    and both of the plain version.  A row-sum route whose f32 sums of
    w (g0 + 10) cancel badly fails this."""
    _cuda()
    B, h, T, qd = 3, 4, 200, 32
    q, k, p, pe, _ = _inputs(B, h, T, qd, 4, dtype, seed=7)
    gen = torch.Generator(device="cuda").manual_seed(11)
    u = torch.rand(B, h, T, T, generator=gen, device="cuda") + 0.1
    counts = torch.floor(1024 * u / u.sum(-1, keepdim=True))
    rest = 1024 - counts.sum(-1, keepdim=True)
    counts = counts + (torch.arange(T, device="cuda") < rest).float()
    assert counts.max().item() <= 255
    w = (counts / 1024).to(dtype)
    assert torch.equal(w.float().sum(-1), torch.ones(B, h, T, device="cuda"))
    g0 = torch.randint(-32, 33, (B, h, T, T), generator=gen,
                       device="cuda").float() / 16
    coin = torch.zeros((), device="cuda")
    base = rel_pos_attention_weights_bwd(q, k, p, pe, g0.to(dtype), w, coin)
    shifted = rel_pos_attention_weights_bwd(q, k, p, pe, (g0 + 10).to(dtype),
                                            w, coin)
    want = rel_pos_attention_weights_bwd_ref(q, k, p, pe, g0.to(dtype), w,
                                             coin)
    for a, b, c in zip(shifted, base, want):
        _assert_grads_close(a, c)
        _assert_grads_close(b, c)
        assert (a - b).abs().max().item() <= 1e-4 * c.abs().max().item()


@pytest.mark.gpu
def test_module_trainable_path_matches_plain_path():
    """RelPosAttentionWeights in f32 with train=True: the kernel pair and
    the plain skew path give the same weights and input gradients (all
    coins drawn from the same seed)."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    T, D = 700, 64
    torch.manual_seed(0)
    mod = RelPosAttentionWeights(D, 48, 4, 32, 4).to(dev)
    x0 = torch.randn(2, T, D, device=dev)
    mask = torch.zeros(2, T, dtype=torch.bool, device=dev)
    mask[1, -100:] = True
    pos = compact_rel_pos_encoding(T, 48, device=dev)
    cot = torch.randn(2, 4, T, T, device=dev)
    runs = []
    for use_kernel in (True, False):
        set_attention_kernel(mod, use_kernel)
        mod.zero_grad()
        x = x0.clone().requires_grad_(True)
        before = rel_pos_attention_weights_bwd.launches
        w = mod(x, pos, mask, train=True, batch_count=5000.0,
                gens=TrainGenerators(1, dev))
        (w * cot).sum().backward()
        assert rel_pos_attention_weights_bwd.launches == before + use_kernel
        runs.append((w.detach(), x.grad,
                     mod.in_proj.weight.grad.clone(),
                     mod.linear_pos.weight.grad.clone()))
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, atol=1e-4 * b.abs().max().item(),
                                   rtol=0)


@pytest.mark.gpu
def test_bwd_cuda_tensor_never_takes_plain_version():
    """A head dim the backward is not built for raises on the card."""
    _cuda()
    q, k, p, pe, mask = _inputs(3, 4, 64, 16, 4, torch.float32, seed=0)
    w = torch.rand(3, 4, 64, 64, device="cuda")
    with pytest.raises(ValueError):
        rel_pos_attention_weights_bwd(q, k, p, pe, w, w,
                                      torch.zeros((), device="cuda"))


def _assert_conv_close(got, want, dtype):
    """The conv kernels sum the same f32 products as the plain versions in
    another order and round once: bf16 within one rounding of each value,
    f32 within 2e-6 of the tensor's largest |value| (sums of up to 31
    products)."""
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        bound = 2e-6 * max(1.0, want.abs().max().item())
    else:
        bound = 2.0 ** -7 * want.float().abs() + 1e-6
    diff = (got.float() - want.float()).abs()
    assert (diff <= bound).all(), diff.max().item()


def _conv_inputs(B, T, C, k, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    v = torch.randn(B, T, C, generator=g, device="cuda").to(dtype)
    w = (0.3 * torch.randn(C, k, generator=g, device="cuda")).to(dtype)
    b = (0.3 * torch.randn(C, generator=g, device="cuda")).to(dtype)
    return v, w, b


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,C,k", [(3, 37, 40, 5), (4, 320, 512, 7),
                                     (2, 700, 512, 31), (4, 128, 192, 9),
                                     (2, 5, 64, 31), (2, 70, 37, 3),
                                     (16, 1280, 512, 31), (16, 640, 512, 15),
                                     (16, 320, 512, 7), (16, 128, 192, 9)])
def test_depthwise_conv_kernel_matches_plain(dtype, B, T, C, k):
    """Ragged T and C (no multiple of the 64-row, 64-channel tiles; C=37
    also odd and no multiple of 16 bytes, so copied and stored element by
    element), T < k (5 rows under a 31-tap filter: all but the taps that
    reach the sequence are SAME padding), and the main path's four levels
    at B=16, whose runs of tiles span several 64-row tiles a block."""
    _cuda()
    torch.backends.cudnn.allow_tf32 = False
    v, w, b = _conv_inputs(B, T, C, k, dtype, seed=T + k)
    before = depthwise_conv1d.launches
    got = depthwise_conv1d(v, w, b)
    torch.cuda.synchronize()
    assert depthwise_conv1d.launches == before + 1
    _assert_conv_close(got, depthwise_conv1d_ref(v, w, b), dtype)


def _check_conv_bwd(B, T, C, k, dtype):
    """One backward launch on seeded inputs against the plain backward: dv
    element by element as the forward; dw and db, sums over B x T products
    in f32 rounded to the dtype, within 1e-4 of each tensor's largest
    |value| (bf16: one rounding more).  Returns the inputs and outputs."""
    v, w, _ = _conv_inputs(B, T, C, k, dtype, seed=T + k + 1)
    g = torch.randn(B, T, C, generator=torch.Generator(device="cuda")
                    .manual_seed(B + T + C), device="cuda").to(dtype)
    before = depthwise_conv1d_bwd.launches
    out = depthwise_conv1d_bwd(v, g, w)
    torch.cuda.synchronize()
    assert depthwise_conv1d_bwd.launches == before + 1
    want = depthwise_conv1d_bwd_ref(v, g, w)
    _assert_conv_close(out[0], want[0], dtype)
    for got, ref in zip(out[1:], want[1:]):
        assert got.dtype == dtype and got.shape == ref.shape
        tol = 1e-4 * ref.float().abs().max().item()
        if dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * ref.float().abs()
        assert ((got.float() - ref.float()).abs() <= tol).all()
    return (v, g, w), out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,C,k", [(3, 37, 40, 5), (8, 640, 512, 15),
                                     (2, 700, 512, 31), (8, 1280, 512, 31),
                                     (8, 320, 512, 7), (8, 128, 192, 9),
                                     (2, 70, 37, 3), (2, 5, 64, 31),
                                     (1, 1279, 512, 31),
                                     (16, 2560, 512, 31)])
def test_depthwise_conv_bwd_kernel_matches_plain(dtype, B, T, C, k):
    """dv, dw and db against the plain backward (``_check_conv_bwd``), and
    the same bits on a second run: the main path's four levels at B=8;
    ragged T and C (C=37 odd and no multiple of 16 bytes: copied and stored
    element by element); T < k; B=1; and a long run of tiles a block
    (B=16, T=2560: 40,960 products in each f32 dw sum)."""
    _cuda()
    torch.backends.cudnn.allow_tf32 = False
    args, out = _check_conv_bwd(B, T, C, k, dtype)
    again = depthwise_conv1d_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_depthwise_conv_bwd_kernel_shapes_back_to_back(dtype):
    """The backward keeps completion counters in its scratch between calls:
    a shape with fewer channel slices and blocks between two calls of a
    larger one, each right, the repeat of the first with its bits."""
    _cuda()
    torch.backends.cudnn.allow_tf32 = False
    args, first = _check_conv_bwd(8, 640, 512, 15, dtype)
    _check_conv_bwd(3, 37, 192, 5, dtype)
    _check_conv_bwd(2, 1280, 512, 31, dtype)
    again = depthwise_conv1d_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
def test_conv_module_trainable_kernel_matches_plain():
    """ConvolutionModule in f32 with gradients recorded: the kernel pair
    and F.conv1d give the same output and parameter gradients."""
    dev = _cuda()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    mod = ConvolutionModule(64, 15).to(dev)
    x = torch.randn(2, 300, 64, device=dev)
    mask = torch.zeros(2, 300, dtype=torch.bool, device=dev)
    mask[1, -40:] = True
    runs = []
    for on in (True, False):
        set_conv_kernel(mod, on)
        mod.zero_grad()
        before = (depthwise_conv1d.launches, depthwise_conv1d_bwd.launches)
        out = mod(x, mask)
        out.square().sum().backward()
        assert (depthwise_conv1d.launches - before[0],
                depthwise_conv1d_bwd.launches - before[1]) == (on, on)
        runs.append([out.detach()] + [p.grad.clone()
                                      for p in mod.parameters()])
    for a, b in zip(*runs):
        torch.testing.assert_close(a, b, atol=1e-4 * b.abs().max().item(),
                                   rtol=0)


def _assert_sums_match(got, want, spread=None):
    """na and w @ v.  bf16: one rounding, plus 2^-7 ``spread`` where the
    sum's inputs were rounded by each side on its own (na sums weights
    that may differ by one rounding: spread = w[:, 0] @ |nv|).  f32: both
    sides sum T products in different orders, and the plain version's
    cuBLAS sum alone strays 3-7e-6 from an f64 sum at |value| about 5, so
    the bound is 2e-6 of max(1, the tensor's largest |value|)."""
    assert got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        bound = 2e-6 * max(1.0, want.abs().max().item())
    else:
        bound = 2.0 ** -7 * want.float().abs() + 1e-6
        if spread is not None:
            bound = bound + 2.0 ** -7 * spread
    assert (diff <= bound).all(), diff.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,qd,hid", [(37, 8, 48), (640, 32, 384),
                                      (1029, 32, 144), (37, 32, 384),
                                      (641, 8, 144), (641, 32, 48),
                                      (1029, 8, 384), (1279, 32, 384),
                                      (1279, 8, 48)])
def test_nonlin_kernel_matches_plain(dtype, T, qd, hid):
    """The fused kernel: the weights within one rounding of the plain
    version's and the same bits as the inference kernel's (each dtype's
    builds of the two share one code path for the weights), and na as
    ``_assert_sums_match`` holds it against the plain version, which
    applies its own rounded weights in f32.  Ragged T (no
    multiple of the bf16 build's 64-row tiles, 128-key chunks or 8),
    padded keys and a fully masked sequence, every hid and qd."""
    _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _inputs(4, 4, T, qd, 4, dtype, seed=T + 2)
    nv = torch.randn(4, T, hid, device="cuda").to(dtype)
    before = rel_pos_attention_weights_nonlin.launches
    w, na = rel_pos_attention_weights_nonlin(*args, nv)
    torch.cuda.synchronize()
    assert rel_pos_attention_weights_nonlin.launches == before + 1
    want_w, want_na = rel_pos_attention_weights_nonlin_ref(*args, nv)
    _assert_matches(w, want_w)
    assert torch.equal(w, rel_pos_attention_weights(*args))
    _assert_sums_match(na, want_na,
                       torch.matmul(want_w[:, 0].float(), nv.float().abs()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [37, 640, 641, 1029, 1279, 2560])
def test_apply_kernel_matches_plain(dtype, T):
    """weights @ values, as ``_assert_sums_match`` holds them, over padded
    keys and a fully masked sequence; T=37, 641, 1029 and 1279 (no
    multiple of 8 or of the bf16 build's 64-row tiles and 64-key chunks)
    take the kernels' unaligned loads."""
    _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    w = rel_pos_attention_weights_ref(*_inputs(4, 4, T, 8, 4, dtype,
                                               seed=T + 3))
    v = torch.randn(4, 4, T, 12, device="cuda").to(dtype)
    before = attention_apply.launches
    got = attention_apply(w, v)
    torch.cuda.synchronize()
    assert attention_apply.launches == before + 1
    _assert_sums_match(got, attention_apply_ref(w, v))


@pytest.mark.gpu
def test_layer_kernel_config_launches_and_matches_plain(monkeypatch):
    """One f32 encoder layer at T=700 (above the gates) in the kernel
    configuration: one fused launch, two application launches and two conv
    launches per forward, no inference-weights launch, and the output of
    the plain path."""
    import zipvoice_torch.models.zipformer as zipformer

    dev = _cuda()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.manual_seed(0)
    T = 700
    layer = ZipformerEncoderLayer(64, 48, 4, 32, 4, 12, 96, 15).to(dev)
    x = torch.randn(2, T, 64, device=dev)
    mask = torch.zeros(2, T, dtype=torch.bool, device=dev)
    mask[1, -100:] = True
    pos = compact_rel_pos_encoding(T, 48, device=dev)
    wrappers = (rel_pos_attention_weights, rel_pos_attention_weights_nonlin,
                attention_apply, depthwise_conv1d)
    outs = []
    for on in (True, False):
        set_kernel_config(layer, on)
        if not on:
            set_attention_kernel(layer, False)
        before = [f.launches for f in wrappers]
        with torch.no_grad():
            outs.append(layer(x, pos, None, mask))
        counts = [f.launches - n for f, n in zip(wrappers, before)]
        assert counts == ([0, 1, 2, 2] if on else [0, 0, 0, 0]), counts
    torch.testing.assert_close(outs[0], outs[1], atol=1e-4, rtol=0)
    assert zipformer.MIN_APPLY_SEQ_LEN <= T and zipformer.MIN_SEQ_LEN <= T


@pytest.mark.gpu
def test_new_kernels_reject_what_they_are_not_built_for():
    """An even or unbuilt kernel size, an unbuilt hid, a vd other than 12
    and an unbuilt qd raise on the card (the attention kernels in both
    dtypes); none falls back to the plain version."""
    _cuda()
    v, w, b = _conv_inputs(2, 64, 32, 7, torch.float32, seed=0)
    for k in (4, 11):
        with pytest.raises(ValueError):
            depthwise_conv1d(v, torch.zeros(32, k, device="cuda"), b)
        with pytest.raises(ValueError):
            depthwise_conv1d_bwd(v, v, torch.zeros(32, k, device="cuda"))
    with pytest.raises(ValueError):
        depthwise_conv1d(v.half(), w.half(), b.half())
    for dtype in (torch.float32, torch.bfloat16):
        args = _inputs(3, 4, 64, 8, 4, dtype, seed=0)
        for hid in (47, 96, 386):
            with pytest.raises(ValueError):
                rel_pos_attention_weights_nonlin(
                    *args, torch.zeros(3, 64, hid, device="cuda", dtype=dtype))
        with pytest.raises(ValueError):
            rel_pos_attention_weights_nonlin(
                *_inputs(3, 4, 64, 16, 4, dtype, seed=0),
                torch.zeros(3, 64, 48, device="cuda", dtype=dtype))
        wts = rel_pos_attention_weights_ref(*args)
        with pytest.raises(ValueError):
            attention_apply(wts, torch.zeros(3, 4, 64, 16, device="cuda",
                                             dtype=dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_load_model_dir_on_the_card(tmp_path, dtype):
    """``load_model_dir`` and ``load_vocos`` put every parameter on the
    card: the Linear and Conv1d weights in the requested dtype, the rest
    f32."""
    from zipvoice_torch.bin.make_model_dir import (
        TINY_CONFIG,
        TINY_VOCOS,
        make_model_dir,
    )
    from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos

    _cuda()
    make_model_dir(str(tmp_path), config=TINY_CONFIG,
                   vocos_config=TINY_VOCOS)
    model, _ = load_model_dir(str(tmp_path), dtype=dtype)
    vocos = load_vocos(str(tmp_path / "pytorch_model.bin"), dtype=dtype)
    for module in (model.fm_decoder, model.text_encoder, vocos.backbone):
        for m in module.modules():
            for p in m.parameters(recurse=False):
                assert p.device.type == "cuda"
                want = (dtype if isinstance(m, (torch.nn.Linear,
                                                torch.nn.Conv1d))
                        else torch.float32)
                assert p.dtype == want, (m, p.dtype)
    assert model.embed.weight.device.type == "cuda"
    assert all(p.dtype == torch.float32 for p in vocos.head.parameters())


@pytest.mark.gpu
def test_cli_on_the_card(tmp_path):
    """The CLI on the card (its default platform) with a tiny model dir:
    exit 0, a finite 24 kHz wav, and a text long enough that the top
    level's 768 frames pass the attention kernel's gate."""
    from zipvoice_torch.bin.infer_zipvoice import main
    from zipvoice_torch.bin.make_model_dir import (
        TINY_CONFIG,
        TINY_VOCOS,
        make_model_dir,
    )
    from zipvoice_torch.frontend.audio import load_wav, save_wav
    from zipvoice_torch.infer.workload import speech_like_wav

    _cuda()
    make_model_dir(str(tmp_path), config=TINY_CONFIG,
                   vocos_config=TINY_VOCOS)
    prompt = str(tmp_path / "prompt.wav")
    save_wav(prompt, speech_like_wav(1, seconds=2.0), 24000)
    out = str(tmp_path / "out.wav")
    before = rel_pos_attention_weights.launches
    assert main([
        "--model-dir", str(tmp_path), "--vocoder-path",
        str(tmp_path / "pytorch_model.bin"), "--prompt-wav", prompt,
        "--prompt-text", "Hi, there, my friend.", "--text",
        "We walked along the quiet river at dawn, and then the birds "
        "began to sing above us in the tall trees.", "--num-step", "2",
        "--res-wav-path", out, "--bf16",
    ]) == 0
    assert rel_pos_attention_weights.launches > before
    wav = load_wav(out, 24000)
    assert wav.shape[0] == 1 and wav.shape[1] > 0
    assert np.isfinite(wav).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["zipvoice_dialog", "zipvoice_dialog_stereo"])
def test_load_dialog_model_dir_on_the_card(tmp_path, name):
    """``load_model_dir`` puts the dialog models on the card in bf16: the
    Linear and Conv1d weights (the stereo model's two projection pairs
    among them) bf16, the rest f32, and the [S1]/[S2] ids from the
    tokenizer."""
    from zipvoice_torch.bin.make_model_dir import TINY_CONFIG, make_model_dir
    from zipvoice_torch.utils.checkpoint_io import load_model_dir

    _cuda()
    make_model_dir(str(tmp_path), name, config=TINY_CONFIG)
    model, tok = load_model_dir(str(tmp_path), name, dtype=torch.bfloat16)
    assert (model.spk_a_id, model.spk_b_id) == (tok.spk_a_id, tok.spk_b_id)
    for module in (model.fm_decoder, model.text_encoder):
        for m in module.modules():
            for p in m.parameters(recurse=False):
                assert p.device.type == "cuda"
                want = (torch.bfloat16 if isinstance(m, (torch.nn.Linear,
                                                         torch.nn.Conv1d))
                        else torch.float32)
                assert p.dtype == want, (m, p.dtype)
    assert model.spk_embed.weight.device.type == "cuda"
    assert model.spk_embed.weight.dtype == torch.float32
    stereo = name.endswith("stereo")
    assert isinstance(model.fm_decoder.in_proj, torch.nn.ModuleList) == stereo


def _stereo_sample(dtype, use_kernel, num_step=2, T=1280, seed=0):
    """A tiny ZipVoice-Dialog-Stereo's ``sample`` of one two-channel
    (T, 2F) request on the card: (features, #1's launches)."""
    from zipvoice_torch.bin.make_model_dir import TINY_CONFIG
    from zipvoice_torch.models.dialog import ZipVoiceDialogStereo
    from zipvoice_torch.models.zipvoice import build_zipvoice

    model = build_zipvoice(model_class=ZipVoiceDialogStereo, dtype=dtype,
                           seed=seed, vocab_size=40, spk_a_id=38,
                           spk_b_id=39, **TINY_CONFIG)
    set_attention_kernel(model, use_kernel)
    F = 2 * model.feat_dim
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(1, 38, (1, 64), generator=g, device="cuda")
    tokens[0, [0, 20, 41]] = torch.tensor([38, 39, 38], device="cuda")
    tokens[0, -1] = 0
    prompt = torch.zeros(1, T, F, device="cuda")
    prompt[0, :300] = torch.randn(300, F, generator=g, device="cuda")
    lens = torch.tensor([T], device="cuda")
    before = rel_pos_attention_weights.launches
    x1, _ = model.sample(
        tokens=tokens, tokens_lens=torch.tensor([63], device="cuda"),
        prompt_tokens_lens=torch.tensor([20], device="cuda"),
        prompt_features=prompt,
        prompt_features_lens=torch.tensor([300], device="cuda"),
        features_lens=lens,
        noise=torch.randn(1, T, F, generator=g, device="cuda"),
        num_step=num_step, guidance_scale=1.5,
    )
    torch.cuda.synchronize()
    return model, x1, rel_pos_attention_weights.launches - before


@pytest.mark.gpu
def test_stereo_sample_launches_the_kernel():
    """The stereo model's two-stream decoder at T=1280 in bf16 launches #1
    once per decoder call at every layer whose level passes the gate (the
    tiny U-Net's levels 1280, 640, 320, 640, 1280: four layers), and its
    (T, 2F) features are finite."""
    from zipvoice_torch.models.zipformer import MIN_SEQ_LEN, EncoderStack

    _cuda()
    model, x1, launches = _stereo_sample(torch.bfloat16, True, num_step=2)
    gated = 0
    for stack in model.fm_decoder.encoders:
        ds = stack.downsample_factor if isinstance(stack, EncoderStack) else 1
        enc = stack.encoder if isinstance(stack, EncoderStack) else stack
        gated += len(enc.layers) * ((1280 + ds - 1) // ds >= MIN_SEQ_LEN)
    assert gated == 4
    assert launches == gated * 2
    assert x1.shape == (1, 1280, 2 * model.feat_dim)
    assert torch.isfinite(x1).all()


@pytest.mark.gpu
def test_stereo_sample_kernel_matches_plain_path():
    """The same stereo sample in f32 (TF32 off) with #1 and on the plain
    skew path: features within 5e-3, chip_smoke.py's PATH_ATOL of 5e-2 in
    mel units times the pipeline's 0.1 feature scale."""
    _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, got, launches = _stereo_sample(torch.float32, True)
    _, want, none = _stereo_sample(torch.float32, False)
    assert launches > 0 and none == 0
    torch.testing.assert_close(got, want, atol=5e-3, rtol=0)


@pytest.mark.gpu
def test_engine_batches_back_to_back_match_sample_batch(tmp_path):
    """Two batches of different buckets (256 and 1280 frames, the second
    through #1) go through ``TTSEngine`` back to back, the second queued on
    the card while the first's features are copied to the host: each
    batch's features, as the finisher reads them, equal ``_sample_batch``
    on that batch alone with the same noise, bit for bit.  A copy that
    raced the next batch, or memory the allocator handed out again too
    early, would differ."""
    from zipvoice_torch.bin.make_model_dir import (
        TINY_CONFIG,
        TINY_VOCOS,
        make_model_dir,
    )
    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.serving.server import TTSEngine
    from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos

    _cuda()
    make_model_dir(str(tmp_path), "zipvoice_distill", config=TINY_CONFIG,
                   vocos_config=TINY_VOCOS)
    model, tok = load_model_dir(str(tmp_path), "zipvoice_distill",
                                dtype=torch.bfloat16)
    vocos = load_vocos(str(tmp_path / "pytorch_model.bin"),
                       dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    F = model.feat_dim
    # 5 and 15 frames a prompt token: 20 text tokens land at 256 frames,
    # 60 at 1280
    entries = [{"tokens": list(rng.randint(3, 300, 20)),
                "features": (0.5 * rng.randn(n, F)).astype(np.float32),
                "prompt_rms": 0.1} for n in (100, 300)]
    texts = [" ".join(["hello"] * 3), " ".join(["hello"] * 9)]
    tokens = [tok.texts_to_token_ids([t])[0] for t in texts]
    assert [len(t) for t in tokens] == [20, 62]

    pipe = InferencePipeline(model, vocos, seed=3, tokenizer=tok)
    read = []
    vocode = pipe._vocode_chunks

    def keep(chunks):
        read.append([c.copy() for c in chunks])
        return vocode(chunks)

    pipe._vocode_chunks = keep
    engine = TTSEngine(pipe, max_batch=2, batch_window_ms=2000.0,
                       num_step=2, guidance_scale=3.0)
    before = rel_pos_attention_weights.launches
    try:
        done = [engine.submit(e, t) for e, t in zip(entries, texts)]
        replies = [d.get(timeout=300) for d in done]
    finally:
        engine.close()
    assert [r[0] for r in replies] == ["ok", "ok"]
    assert rel_pos_attention_weights.launches > before
    assert len(read) == 2
    fresh = InferencePipeline(model, vocos, seed=3, tokenizer=tok)
    for got, entry, toks in zip(read, entries, tokens):
        feats, lens = fresh._sample_batch(
            [toks], [entry["tokens"]], [entry["features"]], num_step=2,
            guidance_scale=3.0, speed=[1.0], t_shift=0.5)
        np.testing.assert_array_equal(got[0], feats[0, : lens[0]])
    assert {T for _, _, T in fresh._seen_buckets} == {256, 1280}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_dequantization_on_the_card_matches_the_cpu(dtype):
    """``quantize_state_dict`` of the card's weights and
    ``dequantize_state_dict`` on the card give the CPU's bits."""
    from zipvoice_torch.bin.make_model_dir import TINY_CONFIG
    from zipvoice_torch.models.zipvoice import build_zipvoice
    from zipvoice_torch.serving.quantize import (
        dequantize_state_dict,
        quantize_state_dict,
    )

    _cuda()
    config = dict(TINY_CONFIG, fm_decoder_dim=144,
                  fm_decoder_cnn_module_kernel=[31, 15, 7, 15, 31])
    sd = build_zipvoice(device="cpu", vocab_size=40, **config).state_dict()
    cpu = quantize_state_dict(sd)
    card = quantize_state_dict({k: v.cuda() for k, v in sd.items()})
    quantized = [k for k, v in cpu.items() if isinstance(v, dict)]
    assert any(k.endswith("depthwise_conv.weight") for k in quantized)
    for k in quantized:
        for part in ("q", "scale"):
            assert torch.equal(card[k][part], cpu[k][part]), k
    want = dequantize_state_dict(cpu, dtype)
    got = dequantize_state_dict(
        {k: {n: t.cuda() for n, t in v.items()} if k in quantized
         else v.cuda() for k, v in cpu.items()}, dtype)
    for k in quantized:
        assert got[k].device.type == "cuda" and got[k].dtype == dtype
        assert torch.equal(got[k].cpu(), want[k]), k


# tests/test_train_cli.py's TINY_CFG (that file imports JAX)
TRAIN_TINY_CFG = dict(
    fm_decoder_downsampling_factor=[1, 2, 1],
    fm_decoder_num_layers=[1, 1, 1],
    fm_decoder_cnn_module_kernel=[7, 7, 7],
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
    feat_dim=100,
)


@pytest.mark.gpu
def test_train_cli_on_the_card(tmp_path):
    """``bin/train_zipvoice`` on the card (its default platform) at
    TINY_CFG widths: six 6.6 s utterances (619 frames, the 640-frame
    bucket) and --max-duration 14 make two steps of two; each forward
    passes the gate at the two full-rate stacks, so #4 and #5 launch twice
    each a step, 4 and 4 in all, and the losses are finite."""
    import json
    import string

    from zipvoice_torch.bin import compute_fbank, prepare_dataset
    from zipvoice_torch.bin.train_zipvoice import main
    from zipvoice_torch.frontend.audio import save_wav
    from zipvoice_torch.infer.workload import speech_like_wav

    _cuda()
    rows = []
    for i in range(6):
        wav = str(tmp_path / f"u{i}.wav")
        save_wav(wav, speech_like_wav(i, seconds=6.6), 24000)
        rows.append(f"u{i}\thello world number {i}.\t{wav}")
    (tmp_path / "train.tsv").write_text("\n".join(rows) + "\n")
    chars = ["_"] + list(string.ascii_lowercase) + list(" .,!?0123456789")
    tokens = tmp_path / "tokens.txt"
    tokens.write_text("".join(f"{c}\t{i}\n" for i, c in enumerate(chars)))
    manifest = prepare_dataset.main([
        "--tsv-path", str(tmp_path / "train.tsv"), "--output-dir",
        str(tmp_path / "manifests")])
    compute_fbank.main(["--manifest", manifest, "--output-dir",
                        str(tmp_path / "fbank")])
    (tmp_path / "model.json").write_text(json.dumps({"model": TRAIN_TINY_CFG}))
    before = (rel_pos_attention_weights_train.launches,
              rel_pos_attention_weights_bwd.launches)
    history = main([
        "--train-manifest", manifest, "--token-file", str(tokens),
        "--tokenizer", "simple", "--model-config",
        str(tmp_path / "model.json"), "--exp-dir", str(tmp_path / "exp"),
        "--num-epochs", "1", "--max-duration", "14", "--num-buckets", "1",
        "--save-every-n", "0"])
    assert [h["shape"][::2] for h in history] == [(2, 640), (2, 640)]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert (rel_pos_attention_weights_train.launches - before[0],
            rel_pos_attention_weights_bwd.launches - before[1]) == (4, 4)
    assert (tmp_path / "exp" / "epoch-1" / "model.pt").exists()


def _serving_pipe(tmp_path, quantize=None):
    from zipvoice_torch.bin.make_model_dir import BASE_CONFIG, make_model_dir
    from zipvoice_torch.infer.pipeline import InferencePipeline
    from zipvoice_torch.utils.checkpoint_io import load_model_dir, load_vocos

    if not (tmp_path / "model.pt").exists():
        make_model_dir(str(tmp_path), "zipvoice_distill", config=BASE_CONFIG,
                       vocos_config={})
    model, tok = load_model_dir(str(tmp_path), "zipvoice_distill",
                                dtype=torch.bfloat16)
    vocos = load_vocos(str(tmp_path / "pytorch_model.bin"),
                       dtype=torch.bfloat16)
    return InferencePipeline(model, vocos, seed=0, tokenizer=tok,
                             quantize=quantize)


@pytest.mark.gpu
def test_int8_held_plus_peak_below_bf16(tmp_path):
    """At the published widths, int8's weights held plus one request's
    allocator peak above them lie below bf16's: int8 expands one stack at
    a time, so its transient is one stack's bf16 copy, not the model's."""
    _cuda()
    rng = np.random.RandomState(0)
    F = 100
    args = ([list(rng.randint(3, 300, 120))], [list(rng.randint(3, 300, 40))],
            [(0.5 * rng.randn(250, F)).astype(np.float32)])
    kw = dict(num_step=2, guidance_scale=3.0, speed=[1.0], t_shift=0.5)
    foot = {}
    for quantize in (None, "int8"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        pipe = _serving_pipe(tmp_path, quantize)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - base
        pipe._sample_batch(*args, **kw)  # first touch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        feats, lens = pipe._sample_batch(*args, **kw)
        pipe._vocode_chunks([feats[0, : lens[0]]])
        torch.cuda.synchronize()
        foot[quantize] = held + torch.cuda.max_memory_allocated() - start
        del pipe
        torch.cuda.empty_cache()
    assert foot["int8"] < foot[None], foot


@pytest.mark.gpu
def test_warmed_engine_first_vocode_is_warm(tmp_path):
    """After ``TTSEngine.warm`` at the bucket a request lands in, the
    engine's first request vocodes within 2x the median of the same
    request sent four times more."""
    from zipvoice_torch.serving.server import TTSEngine

    from zipvoice_torch.frontend.batch import bucket_length
    from zipvoice_torch.infer.pipeline import FRAME_BUCKETS, TOKEN_BUCKETS

    _cuda()
    pipe = _serving_pipe(tmp_path)
    rng = np.random.RandomState(1)
    # a 64-frame prompt of 20 tokens, as warm_bucket's, and a text of 241-300
    # tokens: 836-1024 frames, so that the request and the warm-up vocode
    # in the same 1024-frame bucket
    entry = {"tokens": list(rng.randint(3, 300, 20)),
             "features": (0.5 * rng.randn(64, 100)).astype(np.float32),
             "prompt_rms": 0.1}
    reps = 1
    while len(pipe.tokenizer.texts_to_token_ids(
            [" ".join(["hello"] * reps)])[0]) <= 240:
        reps += 1
    text = " ".join(["hello"] * reps)
    n = len(pipe.tokenizer.texts_to_token_ids([text])[0])
    assert n <= 300
    S = bucket_length(20 + n + 1, TOKEN_BUCKETS)
    T = bucket_length(64 + int(np.ceil(64 / 20 * n)), FRAME_BUCKETS)
    assert T == 1024
    engine = TTSEngine(pipe, max_batch=1, num_step=2, guidance_scale=3.0)
    try:
        engine.warm(1, S, T)
        vocode_ms = []
        for _ in range(5):
            status, _, tm = engine.submit(entry, text).get(timeout=300)
            assert status == "ok"
            vocode_ms.append((tm["vocoded"] - tm["device_done"]) * 1e3)
    finally:
        engine.close()
    assert pipe._seen_buckets == {(1, S, T)}
    assert vocode_ms[0] <= 2.0 * np.median(vocode_ms[1:]), vocode_ms
