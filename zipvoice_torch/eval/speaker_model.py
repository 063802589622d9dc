"""ECAPA-TDNN speaker-verification head over WavLM features (the port's
copy of ``zipvoice_tpu/eval/speaker_model.py``; it runs on any torch
device).

Own implementation of the architecture used by ZipVoice's SIM-o metric
(reference zipvoice/eval/models/ecapa_tdnn_wavlm.py, which builds on the
public lawlict/ECAPA-TDNN design): a learned softmax-weighted sum of all
WavLM hidden states -> instance norm -> Conv1dReluBn -> 3x SE-Res2Block
(dilations 2/3/4, scale 8) -> 1x1 conv -> attentive stats pooling ->
BatchNorm -> linear to 192-d embeddings.

Differences: the SSL backbone is HuggingFace ``WavLMModel`` (local path;
this environment has no torch.hub/s3prl access).  Module names match the
reference so the released ``wavlm_large_finetune.pth`` head weights load
directly (feature_weight, layer1..layer4, conv, pooling, bn, linear).
"""

import torch
import torch.nn as nn
import torch.nn.functional as F


class Conv1dReluBn(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size=1, stride=1,
                 padding=0, dilation=1):
        super().__init__()
        self.conv = nn.Conv1d(
            in_channels, out_channels, kernel_size, stride, padding, dilation
        )
        self.bn = nn.BatchNorm1d(out_channels)

    def forward(self, x):
        return self.bn(F.relu(self.conv(x)))


class Res2Conv1dReluBn(nn.Module):
    """Res2Net-style grouped temporal convolution."""

    def __init__(self, channels, kernel_size=1, stride=1, padding=0,
                 dilation=1, scale=4):
        super().__init__()
        assert channels % scale == 0
        self.scale = scale
        self.width = channels // scale
        self.nums = scale if scale == 1 else scale - 1
        self.convs = nn.ModuleList([
            nn.Conv1d(self.width, self.width, kernel_size, stride, padding,
                      dilation)
            for _ in range(self.nums)
        ])
        self.bns = nn.ModuleList([
            nn.BatchNorm1d(self.width) for _ in range(self.nums)
        ])

    def forward(self, x):
        chunks = torch.split(x, self.width, dim=1)
        out = []
        sp = None
        for i in range(self.nums):
            sp = chunks[i] if i == 0 else sp + chunks[i]
            sp = self.bns[i](F.relu(self.convs[i](sp)))
            out.append(sp)
        if self.scale != 1:
            out.append(chunks[self.nums])
        return torch.cat(out, dim=1)


class SE_Connect(nn.Module):
    def __init__(self, channels, se_bottleneck_dim=128):
        super().__init__()
        self.linear1 = nn.Linear(channels, se_bottleneck_dim)
        self.linear2 = nn.Linear(se_bottleneck_dim, channels)

    def forward(self, x):
        s = torch.sigmoid(self.linear2(F.relu(self.linear1(x.mean(dim=2)))))
        return x * s.unsqueeze(2)


class SE_Res2Block(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, scale, se_bottleneck_dim):
        super().__init__()
        self.Conv1dReluBn1 = Conv1dReluBn(in_channels, out_channels)
        self.Res2Conv1dReluBn = Res2Conv1dReluBn(
            out_channels, kernel_size, stride, padding, dilation, scale
        )
        self.Conv1dReluBn2 = Conv1dReluBn(out_channels, out_channels)
        self.SE_Connect = SE_Connect(out_channels, se_bottleneck_dim)
        self.shortcut = (
            nn.Conv1d(in_channels, out_channels, kernel_size=1)
            if in_channels != out_channels else None
        )

    def forward(self, x):
        residual = self.shortcut(x) if self.shortcut else x
        x = self.Conv1dReluBn1(x)
        x = self.Res2Conv1dReluBn(x)
        x = self.Conv1dReluBn2(x)
        x = self.SE_Connect(x)
        return x + residual


class AttentiveStatsPool(nn.Module):
    def __init__(self, in_dim, attention_channels=128):
        super().__init__()
        self.linear1 = nn.Conv1d(in_dim, attention_channels, kernel_size=1)
        self.linear2 = nn.Conv1d(attention_channels, in_dim, kernel_size=1)

    def forward(self, x):
        alpha = torch.softmax(
            self.linear2(torch.tanh(self.linear1(x))), dim=2
        )
        mean = torch.sum(alpha * x, dim=2)
        var = torch.sum(alpha * x * x, dim=2) - mean * mean
        std = torch.sqrt(var.clamp(min=1e-9))
        return torch.cat([mean, std], dim=1)


class EcapaWavLM(nn.Module):
    """Speaker embeddings from raw 16 kHz waveforms."""

    def __init__(self, wavlm_path: str = None, feat_dim: int = 1024,
                 channels: int = 512, emb_dim: int = 192,
                 num_hidden_states: int = 25):
        super().__init__()
        self.ssl = None
        if wavlm_path is not None:
            from transformers import WavLMModel

            self.ssl = WavLMModel.from_pretrained(wavlm_path)
            self.ssl.eval()
            num_hidden_states = self.ssl.config.num_hidden_layers + 1
            feat_dim = self.ssl.config.hidden_size
        self.feature_weight = nn.Parameter(torch.zeros(num_hidden_states))
        self.instance_norm = nn.InstanceNorm1d(feat_dim)
        self.layer1 = Conv1dReluBn(feat_dim, channels, kernel_size=5, padding=2)
        self.layer2 = SE_Res2Block(channels, channels, 3, 1, 2, 2, 8, 128)
        self.layer3 = SE_Res2Block(channels, channels, 3, 1, 3, 3, 8, 128)
        self.layer4 = SE_Res2Block(channels, channels, 3, 1, 4, 4, 8, 128)
        self.conv = nn.Conv1d(channels * 3, 1536, kernel_size=1)
        self.pooling = AttentiveStatsPool(1536, attention_channels=128)
        self.bn = nn.BatchNorm1d(1536 * 2)
        self.linear = nn.Linear(1536 * 2, emb_dim)

    def extract_features(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, n) 16 kHz waveform -> weighted hidden-state features
        (B, feat_dim, T)."""
        assert self.ssl is not None, "load with wavlm_path to extract"
        with torch.no_grad():
            out = self.ssl(wav, output_hidden_states=True)
        h = torch.stack(out.hidden_states, dim=0)  # (L+1, B, T, D)
        w = torch.softmax(self.feature_weight, dim=-1)[:, None, None, None]
        x = (w * h).sum(dim=0).transpose(1, 2) + 1e-6
        return self.instance_norm(x)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        return self.head(self.extract_features(wav))

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Weighted hidden-state features (B, feat_dim, T) -> speaker
        embeddings (B, emb_dim)."""
        out1 = self.layer1(x)
        out2 = self.layer2(out1)
        out3 = self.layer3(out2)
        out4 = self.layer4(out3)
        out = torch.cat([out2, out3, out4], dim=1)
        out = F.relu(self.conv(out))
        out = self.bn(self.pooling(out))
        return self.linear(out)

    def load_head_checkpoint(self, path: str) -> None:
        """Load the released speaker-verification head (the reference's
        wavlm_large_finetune.pth 'model' dict), ignoring its s3prl
        feature-extractor weights (HF WavLM supplies those)."""
        sd = torch.load(path, map_location="cpu")
        if "model" in sd:
            sd = sd["model"]
        own = {k for k, _ in self.named_parameters()}
        own |= {k for k, _ in self.named_buffers()}
        filtered = {
            k: v for k, v in sd.items()
            if k in own and not k.startswith("ssl.")
        }
        missing = [
            k for k in own
            if k not in filtered and not k.startswith("ssl.")
        ]
        self.load_state_dict(filtered, strict=False)
        if missing:
            import logging

            logging.warning(f"speaker head: {len(missing)} params not in ckpt")
