"""Operations of ZipVoice's inference, counted from a configuration's
widths and a request's real, unpadded lengths.

An operation is a multiply or an add of a matrix product or a convolution
(a multiply-add counts 2).  Elementwise work (activations, norms, softmax,
the downsampling means) and the inverse FFT of the vocoder's head are not
counted, nor the per-row time and guidance embeddings (under 1e-4 of the
total): what is counted is the work the inputs need, so no implementation
can do it in less, and a rate built on it cannot pass the peak.  Attention
is counted over the T x T pairs a sequence of T frames needs (the query-key
and the position terms, the weights applied to the values and to
NonlinAttention's gated values), not over the 2T - 1 offsets a skewed
implementation computes.
"""

import math


def layer_flops(T: int, d: int, ff: int, h: int, qd: int, pd: int,
                vd: int, pos_dim: int, k: int) -> int:
    """One Zipformer layer over a sequence of T frames at width d."""
    hid = 3 * d // 4
    lin = (
        d * (2 * qd + pd) * h          # attention weights' in_proj
        + 2 * d * (3 * ff // 4)        # feed_forward1
        + d * 3 * hid + hid * d        # NonlinAttention's projections
        + 2 * (2 * d * h * vd)         # self_attn1/2 in and out projections
        + 2 * (2 * d * d + d * d)      # conv_module1/2 in and out projections
        + 2 * d * ff                   # feed_forward2
        + 2 * d * (5 * ff // 4)        # feed_forward3
    )
    per_frame = 2 * lin + 2 * 2 * d * k          # the two depthwise convs
    pairs = (h * (qd + pd)                       # q.k and p.pe
             + 2 * h * vd                        # two weights @ values
             + hid)                              # head 0's weights @ nv
    pos_table = 2 * (2 * T - 1) * pos_dim * h * pd
    return T * per_frame + 2 * T * T * pairs + pos_table


def zipformer_flops(T: int, dim: int, ff: int, h: int, qd: int, pd: int,
                    vd: int, pos_dim: int, downsampling, num_layers, kernels,
                    in_dim: int, out_dim: int) -> int:
    """A TTSZipformer over T frames: its in and out projections and every
    stack's layers at the stack's own length ceil(T / ds)."""
    total = 2 * T * (in_dim * dim + dim * out_dim)
    for ds, n, k in zip(downsampling, num_layers, kernels):
        t = math.ceil(T / ds)
        total += n * layer_flops(t, dim, ff, h, qd, pd, vd, pos_dim, k)
    return total


def text_encoder_flops(cfg: dict, S: int) -> int:
    """The text encoder over S tokens (the prompt's and the text's tokens
    and the trailing pad the pipeline appends)."""
    d = cfg["text_encoder_dim"]
    return zipformer_flops(
        S, d, cfg["text_encoder_feedforward_dim"],
        cfg["text_encoder_num_heads"], cfg["query_head_dim"],
        cfg["pos_head_dim"], cfg["value_head_dim"], cfg["pos_dim"], (1,),
        (cfg["text_encoder_num_layers"],),
        (cfg["text_encoder_cnn_module_kernel"],), cfg["text_embed_dim"],
        cfg["feat_dim"])


def fm_decoder_flops(cfg: dict, T: int) -> int:
    """One fm_decoder pass over one row of T frames (prompt and generated)."""
    return zipformer_flops(
        T, cfg["fm_decoder_dim"], cfg["fm_decoder_feedforward_dim"],
        cfg["fm_decoder_num_heads"], cfg["query_head_dim"],
        cfg["pos_head_dim"], cfg["value_head_dim"], cfg["pos_dim"],
        cfg["fm_decoder_downsampling_factor"],
        cfg["fm_decoder_num_layers"], cfg["fm_decoder_cnn_module_kernel"],
        3 * cfg["feat_dim"], cfg["feat_dim"])


def vocos_flops(voc: dict, N: int) -> int:
    """Vocos over N mel frames: the embedding conv, the ConvNeXt blocks and
    the head's projection."""
    dim, inter = voc["dim"], voc["intermediate_dim"]
    per_frame = (voc["n_mels"] * dim * 7
                 + voc["num_layers"] * (dim * 7 + 2 * dim * inter)
                 + dim * (voc["n_fft"] + 2))
    return 2 * N * per_frame


def row_flops(model_cfg: dict, voc_cfg: dict, num_step: int, cfg_rows: int,
              S: int, T: int, generated: int) -> int:
    """The operations one request row needs: the text encoder once over its
    S tokens, ``num_step`` fm_decoder passes over its T frames for each of
    ``cfg_rows`` rows (2 under classifier-free guidance, 1 for the distilled
    model), and Vocos over its ``generated`` frames."""
    return (text_encoder_flops(model_cfg, S)
            + num_step * cfg_rows * fm_decoder_flops(model_cfg, T)
            + vocos_flops(voc_cfg, generated))
