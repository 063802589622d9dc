"""The plain reference of ZipVoice's inference and of Vocos, in float32.

Plain torch operations over a dict of parameters named as the published
checkpoints name them (the upstream ZipVoice's ``model.pt`` and
charactr/vocos-mel-24khz), with no kernels, caches or lower precision:
every product runs in float32 with TF32 off.  The equations are those of
the upstream ZipVoice (Zipformer layers with relative-position attention,
NonlinAttention, the U-Net of downsampled stacks, flow matching with an
Euler solver and classifier-free guidance) and of Vocos (ConvNeXt and an
inverse STFT), written down again here from the port's own reading of them
so that the benchmark holds a copy that the program cannot change.  Nothing
of the program is imported.

A batch follows the program's padding rule: rows are padded to a common
length T; frames past the batch's longest row repeat that row's last frame
before a downsampling, and each row's padded frames are masked as keys and
zeroed before every convolution.  ``valid_max`` names that longest length
when the reference computes fewer rows than the batch the program ran.
"""

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F



class Params(dict):
    """Parameters by name, and the rounding applied to the inputs of every
    product (matrix products, convolutions, attention): none in float32,
    or ``fp8`` for the correctness check's control."""

    def __init__(self, tensors, rounding=None):
        super().__init__(tensors)
        self.q = rounding or (lambda x: x)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude maps to 448, the format's largest), back in float32."""
    scale = 448.0 / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


def no_tf32() -> None:
    """Full float32 products on the card (TF32 would round to 10 bits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --- parameter names and shapes -------------------------------------------

def _layer_shapes(p: str, d: int, ff: int, h: int, qd: int, pd: int,
                  vd: int, pos_dim: int, k: int) -> Dict[str, tuple]:
    hid = 3 * d // 4
    s = {
        f"{p}self_attn_weights.in_proj.weight": (h * (2 * qd + pd), d),
        f"{p}self_attn_weights.in_proj.bias": (h * (2 * qd + pd),),
        f"{p}self_attn_weights.linear_pos.weight": (h * pd, pos_dim),
        f"{p}nonlin_attention.in_proj.weight": (3 * hid, d),
        f"{p}nonlin_attention.in_proj.bias": (3 * hid,),
        f"{p}nonlin_attention.out_proj.weight": (d, hid),
        f"{p}nonlin_attention.out_proj.bias": (d,),
        f"{p}bypass_mid.bypass_scale": (d,),
        f"{p}norm.log_scale": (),
        f"{p}norm.bias": (d,),
        f"{p}bypass.bypass_scale": (d,),
    }
    for name, width in (("feed_forward1", 3 * ff // 4),
                        ("feed_forward2", ff), ("feed_forward3", 5 * ff // 4)):
        s[f"{p}{name}.in_proj.weight"] = (width, d)
        s[f"{p}{name}.in_proj.bias"] = (width,)
        s[f"{p}{name}.out_proj.weight"] = (d, width)
        s[f"{p}{name}.out_proj.bias"] = (d,)
    for name in ("self_attn1", "self_attn2"):
        s[f"{p}{name}.in_proj.weight"] = (h * vd, d)
        s[f"{p}{name}.in_proj.bias"] = (h * vd,)
        s[f"{p}{name}.out_proj.weight"] = (d, h * vd)
        s[f"{p}{name}.out_proj.bias"] = (d,)
    for name in ("conv_module1", "conv_module2"):
        s[f"{p}{name}.in_proj.weight"] = (2 * d, d)
        s[f"{p}{name}.in_proj.bias"] = (2 * d,)
        s[f"{p}{name}.depthwise_conv.weight"] = (d, 1, k)
        s[f"{p}{name}.depthwise_conv.bias"] = (d,)
        s[f"{p}{name}.out_proj.weight"] = (d, d)
        s[f"{p}{name}.out_proj.bias"] = (d,)
    return s


def _zipformer_shapes(p: str, in_dim: int, out_dim: int, d: int, ff: int,
                      h: int, qd: int, pd: int, vd: int, pos_dim: int,
                      downsampling, num_layers, kernels,
                      time_dim: Optional[int]):
    s = {f"{p}in_proj.weight": (d, in_dim), f"{p}in_proj.bias": (d,)}
    if time_dim is not None:
        s.update({f"{p}time_embed.0.weight": (2 * time_dim, time_dim),
                  f"{p}time_embed.0.bias": (2 * time_dim,),
                  f"{p}time_embed.2.weight": (time_dim, 2 * time_dim),
                  f"{p}time_embed.2.bias": (time_dim,)})
    for i, (ds, n, k) in enumerate(zip(downsampling, num_layers, kernels)):
        q = f"{p}encoders.{i}."
        if ds > 1:
            s[f"{q}downsample.bias"] = (ds,)
            s[f"{q}out_combiner.bypass_scale"] = (d,)
            q += "encoder."
        if time_dim is not None:
            s[f"{q}time_emb.1.weight"] = (d, time_dim)
            s[f"{q}time_emb.1.bias"] = (d,)
        for j in range(n):
            s.update(_layer_shapes(f"{q}layers.{j}.", d, ff, h, qd, pd, vd,
                                   pos_dim, k))
    s[f"{p}out_proj.weight"] = (out_dim, d)
    s[f"{p}out_proj.bias"] = (out_dim,)
    return s


def zipvoice_shapes(cfg: dict) -> Dict[str, tuple]:
    """{name: shape} of every parameter of a ZipVoice model."""
    F_ = cfg["feat_dim"]
    shared = (cfg["query_head_dim"], cfg["pos_head_dim"],
              cfg["value_head_dim"], cfg["pos_dim"])
    s = _zipformer_shapes(
        "fm_decoder.", 3 * F_, F_, cfg["fm_decoder_dim"],
        cfg["fm_decoder_feedforward_dim"], cfg["fm_decoder_num_heads"],
        *shared, cfg["fm_decoder_downsampling_factor"],
        cfg["fm_decoder_num_layers"], cfg["fm_decoder_cnn_module_kernel"],
        cfg["time_embed_dim"])
    s.update(_zipformer_shapes(
        "text_encoder.", cfg["text_embed_dim"], F_, cfg["text_encoder_dim"],
        cfg["text_encoder_feedforward_dim"], cfg["text_encoder_num_heads"],
        *shared, (1,), (cfg["text_encoder_num_layers"],),
        (cfg["text_encoder_cnn_module_kernel"],), None))
    s["embed.weight"] = (cfg["vocab_size"], cfg["text_embed_dim"])
    return s


def vocos_shapes(voc: dict) -> Dict[str, tuple]:
    d, inter, n = voc["dim"], voc["intermediate_dim"], voc["num_layers"]
    s = {"backbone.embed.weight": (d, voc["n_mels"], 7),
         "backbone.embed.bias": (d,),
         "backbone.norm.weight": (d,), "backbone.norm.bias": (d,)}
    for i in range(n):
        p = f"backbone.convnext.{i}."
        s.update({f"{p}gamma": (d,), f"{p}dwconv.weight": (d, 1, 7),
                  f"{p}dwconv.bias": (d,), f"{p}norm.weight": (d,),
                  f"{p}norm.bias": (d,), f"{p}pwconv1.weight": (inter, d),
                  f"{p}pwconv1.bias": (inter,),
                  f"{p}pwconv2.weight": (d, inter), f"{p}pwconv2.bias": (d,)})
    s.update({"backbone.final_layer_norm.weight": (d,),
              "backbone.final_layer_norm.bias": (d,),
              "head.out.weight": (voc["n_fft"] + 2, d),
              "head.out.bias": (voc["n_fft"] + 2,)})
    return s


# --- the Zipformer ---------------------------------------------------------

def _lin(P: Params, name: str, x):
    return F.linear(P.q(x), P.q(P[name + ".weight"]), P.get(name + ".bias"))


def swoosh_l(x):
    return F.softplus(x - 4.0) - 0.08 * x - 0.035


def swoosh_r(x):
    return F.softplus(x - 1.0) - 0.08 * x - 0.313261687


def timestep_embedding(t, dim: int):
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def rel_pos_table(T: int, pos_dim: int, device):
    """(2T - 1, pos_dim): row n encodes the offset n - (T - 1) on a
    log-compressed, atan-warped Fourier basis whose last channel is 1."""
    x = torch.arange(-(T - 1), T, dtype=torch.float32, device=device)[:, None]
    freqs = 1.0 + torch.arange(pos_dim // 2, dtype=torch.float32,
                               device=device)
    c = pos_dim ** 0.5
    xc = c * torch.sign(x) * (torch.log(torch.abs(x) + c) - math.log(c))
    xa = torch.atan(xc / (pos_dim / (2.0 * math.pi)))
    pe = torch.stack([torch.cos(xa * freqs), torch.sin(xa * freqs)],
                     dim=-1).reshape(2 * T - 1, pos_dim)
    pe[:, -1] = 1.0
    return pe


def attention_weights(P, p, x, pe_table, mask, h, qd, pd):
    """Softmax over keys of q.k + p.pe[i - j]: (B, h, T, T)."""
    B, T, _ = x.shape
    proj = _lin(P, p + "in_proj", x)
    q = proj[..., :h * qd].reshape(B, T, h, qd)
    k = proj[..., h * qd:2 * h * qd].reshape(B, T, h, qd)
    pos = proj[..., 2 * h * qd:].reshape(B, T, h, pd)
    pe = F.linear(P.q(pe_table), P.q(P[p + "linear_pos.weight"])).reshape(
        2 * T - 1, h, pd)
    q, k, pos, pe = P.q(q), P.q(k), P.q(pos), P.q(pe)
    scores = torch.einsum("bthd,bshd->bhts", q, k)
    # the offset of key j from query i is j - i, row (j - i) + T - 1
    idx = (torch.arange(T, device=x.device)[None, :]
           - torch.arange(T, device=x.device)[:, None] + T - 1)
    rel = torch.einsum("bthd,nhd->bhtn", pos, pe)
    scores = scores + torch.gather(rel, 3, idx.expand(B, h, T, T))
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, None, :], -1000.0)
    return torch.softmax(scores, dim=-1)


def layer(P, p, src, pe_table, time_emb, mask, c):
    h, qd, pd, vd = c["h"], c["qd"], c["pd"], c["vd"]
    B, T, d = src.shape
    orig = src
    w = attention_weights(P, p + "self_attn_weights.", src, pe_table, mask,
                          h, qd, pd)

    def ff(name, x):
        return _lin(P, p + name + ".out_proj",
                    swoosh_l(_lin(P, p + name + ".in_proj", x)))

    def self_attn(name, x):
        v = _lin(P, p + name + ".in_proj", x).reshape(B, T, h, vd)
        out = torch.matmul(P.q(w), P.q(v.transpose(1, 2)))
        return _lin(P, p + name + ".out_proj",
                    out.transpose(1, 2).reshape(B, T, h * vd))

    def conv(name, x):
        v, s = _lin(P, p + name + ".in_proj", x).chunk(2, dim=-1)
        v = v * torch.sigmoid(s)
        if mask is not None:
            v = v.masked_fill(mask[:, :, None], 0.0)
        wt = P[p + name + ".depthwise_conv.weight"]
        v = F.conv1d(P.q(v.transpose(1, 2)), P.q(wt),
                     P[p + name + ".depthwise_conv.bias"],
                     padding=wt.shape[-1] // 2, groups=d).transpose(1, 2)
        return _lin(P, p + name + ".out_proj", swoosh_r(v))

    def bypass(name, a, b):
        return a + (b - a) * P[p + name + ".bypass_scale"]

    if time_emb is not None:
        src = src + time_emb
    src = src + ff("feed_forward1", src)
    s_, v_, y_ = _lin(P, p + "nonlin_attention.in_proj", src).chunk(3, dim=-1)
    na = torch.matmul(P.q(w[:, 0]), P.q(v_ * torch.tanh(s_)))
    src = src + _lin(P, p + "nonlin_attention.out_proj", na * y_)
    src = src + self_attn("self_attn1", src)
    if time_emb is not None:
        src = src + time_emb
    src = src + conv("conv_module1", src)
    src = src + ff("feed_forward2", src)
    src = bypass("bypass_mid", orig, src)
    src = src + self_attn("self_attn2", src)
    if time_emb is not None:
        src = src + time_emb
    src = src + conv("conv_module2", src)
    src = src + ff("feed_forward3", src)
    scale = torch.rsqrt(torch.mean(
        torch.square(src - P[p + "norm.bias"]), dim=-1, keepdim=True))
    src = src * (scale * torch.exp(P[p + "norm.log_scale"]))
    return bypass("bypass", orig, src)


def encoder(P, p, src, time_emb, mask, num_layers, c):
    pe_table = rel_pos_table(src.shape[1], c["pos_dim"], src.device)
    if time_emb is not None:
        time_emb = _lin(P, p + "time_emb.1", swoosh_r(time_emb))[:, None, :]
    for j in range(num_layers):
        src = layer(P, f"{p}layers.{j}.", src, pe_table, time_emb, mask, c)
    return src


def zipformer(P, p, x, c, downsampling, num_layers, t=None, mask=None,
              valid_max: Optional[int] = None):
    """A TTSZipformer over (B, T, in_dim); ``mask`` (B, T) True at padded
    frames; ``valid_max`` the longest row of the batch the program ran."""
    x = _lin(P, p + "in_proj", x)
    time_emb = None
    if t is not None:
        time_emb = timestep_embedding(t, c["time_dim"])
        time_emb = _lin(P, p + "time_embed.2",
                        swoosh_r(_lin(P, p + "time_embed.0", time_emb)))
    B, T, C = x.shape
    if valid_max is None:
        valid_max = T if mask is None else int((~mask).sum(1).max())
    for i, (ds, n) in enumerate(zip(downsampling, num_layers)):
        q = f"{p}encoders.{i}."
        if ds == 1:
            x = encoder(P, q, x, time_emb, mask, n, c)
            continue
        orig = x
        src = x.index_select(1, torch.clamp(
            torch.arange(T, device=x.device), max=max(valid_max - 1, 0)))
        Td = (T + ds - 1) // ds
        if Td * ds > T:
            src = torch.cat([src, src[:, -1:].expand(B, Td * ds - T, C)], 1)
        wts = torch.softmax(P[q + "downsample.bias"], dim=0)
        src = (src.reshape(B, Td, ds, C) * wts[None, None, :, None]).sum(2)
        src = encoder(P, q + "encoder.", src, time_emb,
                      None if mask is None else mask[:, ::ds], n, c)
        src = src.repeat_interleave(ds, dim=1)[:, :T]
        x = orig + (src - orig) * P[q + "out_combiner.bypass_scale"]
    return _lin(P, p + "out_proj", x)


def _dims(cfg, prefix):
    return dict(h=cfg[prefix + "_num_heads"], qd=cfg["query_head_dim"],
                pd=cfg["pos_head_dim"], vd=cfg["value_head_dim"],
                pos_dim=cfg["pos_dim"], time_dim=cfg["time_embed_dim"])


# --- sampling ------------------------------------------------------------

def time_grid(num_step: int, t_shift: float) -> np.ndarray:
    ts = np.linspace(np.float32(0.0), np.float32(1.0), num_step + 1,
                     dtype=np.float32)
    s = np.float32(t_shift)
    return s * ts / (1 + (s - 1) * ts)


def sample(P: Params, cfg: dict, tokens: torch.Tensor, tokens_lens,
           prompt_features, prompt_lens, features_lens, noise,
           num_step: int, guidance_scale: float, t_shift: float,
           valid_max: Optional[int] = None) -> torch.Tensor:
    """Generated features (B, T, F), prompt included, of ZipVoice's flow
    matching: the text encoder over (B, S) token ids whose row i has
    ``tokens_lens[i]`` tokens and then pads, its output upsampled to each
    row's ``features_lens`` frames by the average token duration (frames
    past the last token read the first pad's output), the prompt's
    features as the speech condition, and ``num_step`` Euler steps of the
    fm_decoder's velocity from ``noise`` on the shifted time grid.  Under
    classifier-free guidance each step also runs the unconditional rows:
    with the speech condition kept and the scale
    doubled up to t = 0.5, without it after."""
    dev = noise.device
    B, T, Fd = noise.shape
    S = tokens.shape[1]
    tmask = torch.arange(S, device=dev)[None, :] >= tokens_lens[:, None]
    emb = zipformer(P, "text_encoder.", F.embedding(tokens, P["embed.weight"]),
                    _dims(cfg, "text_encoder"), (1,),
                    (cfg["text_encoder_num_layers"],), mask=tmask)
    avg = features_lens // tokens_lens
    frame = torch.arange(T, device=dev)[None, :]
    idx = torch.where(avg[:, None] > 0,
                      torch.minimum(frame // avg.clamp(min=1)[:, None],
                                    tokens_lens[:, None]),
                      tokens_lens[:, None]).clamp(max=S - 1)
    text_cond = torch.gather(emb, 1, idx[:, :, None].expand(B, T, Fd))
    mask = frame >= features_lens[:, None]
    speech = prompt_features.masked_fill(
        (frame >= prompt_lens[:, None])[:, :, None], 0.0)
    c = _dims(cfg, "fm_decoder")
    ds, nl = (cfg["fm_decoder_downsampling_factor"],
              cfg["fm_decoder_num_layers"])

    def velocity(t, x, tc, sc, m):
        return zipformer(P, "fm_decoder.", torch.cat([x, tc, sc], dim=-1), c,
                         ds, nl, t=t, mask=m, valid_max=valid_max)

    ts = time_grid(num_step, t_shift)
    x = noise.float()
    for t, t_next in zip(ts[:-1], ts[1:]):
        dt = float(t_next - t)
        if t > 0.5:
            uncond, gs = torch.zeros_like(speech), guidance_scale
        else:
            uncond, gs = speech, 2.0 * guidance_scale
        v2 = velocity(torch.full((2 * B,), float(t), device=dev),
                      torch.cat([x, x]),
                      torch.cat([torch.zeros_like(text_cond), text_cond]),
                      torch.cat([uncond, speech]), torch.cat([mask, mask]))
        v_u, v_c = v2.chunk(2)
        v = (1.0 + gs) * v_c - gs * v_u
        x = x + v * dt
    return x


# --- Vocos -----------------------------------------------------------------

def _hann(n: int, device):
    i = torch.arange(n, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * i / n)).float()


def istft(real, imag, n_fft: int, hop: int, length: int):
    """Inverse STFT with a periodic Hann window, window-square normalized
    overlap-add, the first n_fft / 2 samples (the centering) cut."""
    frames = torch.fft.irfft(torch.complex(real, imag), n=n_fft, dim=-1)
    win = _hann(n_fft, real.device)
    frames = frames * win
    B, T, L = frames.shape
    out_len = (T - 1) * hop + L
    y = torch.zeros(B, out_len, device=real.device)
    env = torch.zeros(out_len, device=real.device)
    pos = (torch.arange(T, device=real.device)[:, None] * hop
           + torch.arange(L, device=real.device)[None, :]).reshape(-1)
    y.index_add_(1, pos, frames.reshape(B, -1))
    env.index_add_(0, pos, (win * win).expand(T, L).reshape(-1))
    y = y / env.clamp(min=1e-11)
    return y[:, n_fft // 2:n_fft // 2 + length]


def vocos(V: Params, voc: dict, mel: torch.Tensor) -> torch.Tensor:
    """Waveform (B, T * hop) of a mel (B, T, n_mels), clamped to [-1, 1]."""
    def conv(x, name, groups=1):
        w = V[name + ".weight"]
        return F.conv1d(V.q(x.transpose(1, 2)), V.q(w), V[name + ".bias"],
                        padding=w.shape[-1] // 2,
                        groups=groups).transpose(1, 2)

    def norm(x, name):
        return F.layer_norm(x, x.shape[-1:], V[name + ".weight"],
                            V[name + ".bias"], 1e-6)

    x = norm(conv(mel, "backbone.embed"), "backbone.norm")
    for i in range(voc["num_layers"]):
        p = f"backbone.convnext.{i}."
        y = norm(conv(x, p + "dwconv", groups=x.shape[-1]), p + "norm")
        y = _lin(V, p + "pwconv2", F.gelu(_lin(V, p + "pwconv1", y)))
        x = x + y * V[p + "gamma"]
    x = _lin(V, "head.out", norm(x, "backbone.final_layer_norm"))
    mag, phase = x.chunk(2, dim=-1)
    mag = torch.exp(mag).clamp(max=1e2)
    wav = istft(mag * torch.cos(phase), mag * torch.sin(phase), voc["n_fft"],
                voc["hop_length"], mel.shape[1] * voc["hop_length"])
    return wav.clamp(-1.0, 1.0)


def strip(x1: torch.Tensor, features_lens, prompt_lens) -> List[torch.Tensor]:
    """Each row's generated frames, the prompt cut off."""
    return [x1[i, int(prompt_lens[i]):int(features_lens[i])]
            for i in range(x1.shape[0])]
