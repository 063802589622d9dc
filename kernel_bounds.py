#!/usr/bin/env python3
"""The least time an H100 could take for each TPU kernel's work.

    python3 kernel_bounds.py

For every function of the JAX package that reaches ``pl.pallas_call``, at
every shape its path gives it (the main path's levels: the attention
kernels at T and T/2, the training pair at B=8 too, the conv at T, T/2,
T/4 and in the text encoder),
prints the bytes it must move (each input read once, each output written
once) and its operations, and the bound: the
larger of bytes over the HBM rate and operations over the bf16 tensor rate
(H100 SXM data sheet, ``chip_smoke.HBM_BYTES_PER_S`` and
``BF16_FLOP_PER_S``).  Pure arithmetic: it needs no card.  Every row is
``chip_smoke.py``'s own count (``attention_traffic``, ``nonlin_traffic``,
``apply_traffic``, ``bwd_traffic``, ``conv_traffic``,
``conv_bwd_traffic``), so the table and its runs cannot drift apart.
"""

from chip_smoke import (
    CONV_LEVELS,
    apply_traffic,
    attention_traffic,
    bound,
    bwd_traffic,
    conv_bwd_traffic,
    conv_traffic,
    nonlin_traffic,
)

BF16 = 2


def rows():
    # inference: B=16 (8 requests doubled for CFG), h=4, T=1280 and its
    # T/2 level, qd=32, pd=4, NonlinAttention hidden 384, value head dim 12;
    # training: B=8; the conv at CONV_LEVELS' (channels, T, kernel size)
    B, h, qd, pd, hid, vd = 16, 4, 32, 4, 384, 12
    for T in (1280, 640):
        wb, wf = attention_traffic(B, h, T, qd, pd)
        yield ("#1 _attn_weights_kernel", f"B=16 T={T} bf16", wb, wf,
               bound(wb, wf))
    for T in (1280, 640):
        nb, nf = nonlin_traffic(B, h, T, qd, pd, hid)
        yield ("#2 _attn_weights_nonlin_kernel", f"B=16 T={T} bf16, hid 384",
               nb, nf, bound(nb, nf))
    for T in (1280, 640):
        ab, af = apply_traffic(B, h, T, vd)
        yield ("#3 _attn_apply_kernel", f"B=16 T={T} bf16, vd 12", ab, af,
               bound(ab, af))
    Bt = 8
    for T in (1280, 640):
        tb, tf = attention_traffic(Bt, h, T, qd, pd, train=True)
        yield ("#4 _attn_weights_train_kernel", f"B=8 T={T} bf16", tb, tf,
               bound(tb, tf))
    for T in (1280, 640):
        bb, bf = bwd_traffic(Bt, h, T, qd, pd, BF16, penalty=False)
        yield ("#5 _attn_weights_bwd_kernel",
               f"B=8 T={T} bf16, penalty off", bb, bf, bound(bb, bf))
    for C, T, k in CONV_LEVELS:
        cb, cf = conv_traffic(B, T, C, k)
        yield ("#6 _dwconv_kernel", f"B=16 T={T} C={C} k={k} bf16", cb, cf,
               bound(cb, cf))
    for C, T, k in CONV_LEVELS:
        db, df = conv_bwd_traffic(Bt, T, C, k)
        yield ("#7 _dwconv_bwd_kernel", f"B=8 T={T} C={C} k={k} bf16", db,
               df, bound(db, df))


def main():
    print("| kernel | shape | MB moved | GFLOP | bound ms | bound by |")
    print("|---|---|---|---|---|---|")
    for name, shape, b, f, (ms, by) in rows():
        print(f"| {name} | {shape} | {b / 1e6:.1f} | {f / 1e9:.2f} | "
              f"{ms:.4f} | {by} |")


if __name__ == "__main__":
    main()
