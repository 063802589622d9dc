"""UTMOS strong-learner MOS predictor (the port's copy of
``zipvoice_tpu/eval/utmos_model.py``; it runs on any torch device).

Architecture from Saeki et al. 2022 ("UTMOS: UTokyo-SaruLab System for
VoiceMOS Challenge 2022"), matching the inference model the reference ships
(zipvoice/eval/models/utmos.py): a wav2vec2-base SSL encoder (conv feature
extractor + 12-layer post-norm transformer with a grouped-conv relative
positional layer), frozen data-domain and judge embeddings concatenated per
frame, a bidirectional LSTM, and a 2048-unit projection head; utterance
score = frame-mean * 2 + 3.

Module/parameter names follow the released checkpoint's state_dict so
``load_state_dict`` works directly; the attention uses
``F.scaled_dot_product_attention`` rather than fairseq's machinery.
"""

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


class ConvFeatureExtractionModel(nn.Module):
    """7-layer strided conv frontend (512ch; strides 5,2,2,2,2,2,2)."""

    def __init__(self, conv_layers: List[Tuple[int, int, int]]):
        super().__init__()
        self.conv_layers = nn.ModuleList()
        in_d = 1
        for i, (dim, k, stride) in enumerate(conv_layers):
            if i == 0:
                layer = nn.Sequential(
                    nn.Conv1d(in_d, dim, k, stride=stride, bias=False),
                    nn.Dropout(0.0),
                    nn.GroupNorm(dim, dim, affine=True),
                    nn.GELU(),
                )
            else:
                layer = nn.Sequential(
                    nn.Conv1d(in_d, dim, k, stride=stride, bias=False),
                    nn.Dropout(0.0),
                    nn.GELU(),
                )
            self.conv_layers.append(layer)
            in_d = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.unsqueeze(1)  # (B, 1, T)
        for layer in self.conv_layers:
            x = layer(x)
        return x  # (B, C, frames)


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, T, D = x.shape
        h = self.num_heads
        q = self.q_proj(x).view(B, T, h, D // h).transpose(1, 2)
        k = self.k_proj(x).view(B, T, h, D // h).transpose(1, 2)
        v = self.v_proj(x).view(B, T, h, D // h).transpose(1, 2)
        out = F.scaled_dot_product_attention(q, k, v)
        out = out.transpose(1, 2).reshape(B, T, D)
        return self.out_proj(out)


class TransformerSentenceEncoderLayer(nn.Module):
    """Post-norm BERT-style layer (gelu FFN 3072)."""

    def __init__(self, feat: int, ffn: int = 3072, heads: int = 12):
        super().__init__()
        self.self_attn = MultiheadAttention(feat, heads)
        self.fc1 = nn.Linear(feat, ffn)
        self.fc2 = nn.Linear(ffn, feat)
        self.self_attn_layer_norm = nn.LayerNorm(feat)
        self.final_layer_norm = nn.LayerNorm(feat)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.self_attn_layer_norm(x + self.self_attn(x))
        x = self.final_layer_norm(x + self.fc2(F.gelu(self.fc1(x))))
        return x


class TransformerEncoder(nn.Module):
    def __init__(self, feat: int = 768, layers: int = 12):
        super().__init__()
        conv = nn.Conv1d(feat, feat, kernel_size=128, padding=64, groups=16)
        # legacy weight_norm keeps the released checkpoint's key names
        # (weight_g/weight_v)
        conv = nn.utils.weight_norm(conv, name="weight", dim=2)
        self.pos_conv = nn.Sequential(conv, nn.GELU())
        self.layer_norm = nn.LayerNorm(feat)
        self.layers = nn.ModuleList(
            [TransformerSentenceEncoderLayer(feat) for _ in range(layers)]
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # grouped-conv positional embedding; even kernel -> trim last frame
        pos = self.pos_conv(x.transpose(1, 2))[:, :, : x.shape[1]]
        x = x + pos.transpose(1, 2)
        x = self.layer_norm(x)
        for layer in self.layers:
            x = layer(x)
        return x


class Wav2Vec2Model(nn.Module):
    def __init__(self):
        super().__init__()
        feat_h1, feat_h2 = 512, 768
        enc_layers = [(feat_h1, 10, 5)] + [(feat_h1, 3, 2)] * 4 + [
            (feat_h1, 2, 2)
        ] * 2
        self.feature_extractor = ConvFeatureExtractionModel(enc_layers)
        self.layer_norm = nn.LayerNorm(feat_h1)
        self.post_extract_proj = nn.Linear(feat_h1, feat_h2)
        self.encoder = TransformerEncoder(feat_h2)
        self.mask_emb = nn.Parameter(torch.zeros(feat_h2))  # ckpt remnant

    def forward(self, wave: torch.Tensor) -> torch.Tensor:
        feats = self.feature_extractor(wave).transpose(1, 2)
        feats = self.post_extract_proj(self.layer_norm(feats))
        return self.encoder(feats)


class UTMOS22Strong(nn.Module):
    """(B, T) 16 kHz waveform -> (B,) MOS in [1, 5]."""

    def __init__(self):
        super().__init__()
        feat_ssl, feat_dom, feat_judge, rnn_h, proj_h = 768, 128, 128, 512, 2048
        self.wav2vec2 = Wav2Vec2Model()
        self.domain_emb = nn.Parameter(
            torch.zeros(1, feat_dom), requires_grad=False
        )
        self.judge_emb = nn.Parameter(
            torch.zeros(1, feat_judge), requires_grad=False
        )
        self.blstm = nn.LSTM(
            input_size=feat_ssl + feat_dom + feat_judge, hidden_size=rnn_h,
            batch_first=True, bidirectional=True,
        )
        self.projection = nn.Sequential(
            nn.Linear(rnn_h * 2, proj_h), nn.ReLU(), nn.Linear(proj_h, 1)
        )

    def forward(self, wave: torch.Tensor, sr: int = 16000) -> torch.Tensor:
        assert sr == 16000, sr
        units = self.wav2vec2(wave)
        B, T, _ = units.shape
        dom = self.domain_emb.unsqueeze(1).expand(B, T, -1)
        judge = self.judge_emb.unsqueeze(1).expand(B, T, -1)
        x = torch.cat([units, dom, judge], dim=2)
        x, _ = self.blstm(x)
        score = self.projection(x)
        return score.mean(dim=1).squeeze(1) * 2 + 3
