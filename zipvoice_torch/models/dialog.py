"""ZipVoice-Dialog and ZipVoice-Dialog-Stereo in PyTorch (counterpart of
``zipvoice_tpu/models/dialog.py``).

Dialog adds a 2-entry speaker-turn embedding, picked per token by the
cumulative parity of the [S1]/[S2] tokens, to the text encoder's output,
and anchors the training loss's speech-condition span at the end of each
row (50-100% of it).  Stereo builds the fm_decoder in two-stream mode (in =
(5F, 3F), out = (2F, F)), so two-channel (2F) and mixed-channel (F)
features share one trunk, and adds a speaker-exclusive energy loss.  The
``state_dict`` is the reference layout: ``spk_embed.weight`` and, for
stereo, ``fm_decoder.in_proj.0`` ... ``fm_decoder.out_proj.1``.
"""

from typing import Optional

import torch
import torch.nn as nn

from zipvoice_torch.models.zipformer import TrainGenerators
from zipvoice_torch.models.zipvoice import ZipVoice


class ZipVoiceDialog(ZipVoice):
    """Two-speaker single-channel dialogue TTS."""

    mask_percent = (0.5, 1.0)
    mask_suffix = True

    def __init__(self, spk_a_id: int = 360, spk_b_id: int = 361, **config):
        super().__init__(**config)
        self.spk_a_id = spk_a_id
        self.spk_b_id = spk_b_id
        self.spk_embed = nn.Embedding(2, self.feat_dim)
        nn.init.normal_(self.spk_embed.weight, std=0.1)

    def spk_indices(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) token ids -> the speaker-embedding index of each
        position: the cumulative parity of the [S1]/[S2] tokens up to and
        including it (0 or 1), and -1 at pad positions."""
        turn = (tokens == self.spk_a_id) | (tokens == self.spk_b_id)
        parity = torch.cumsum(turn.long(), dim=1) % 2
        return torch.where(tokens == self.pad_id, -1, parity)

    def forward_text_embed(self, tokens, tokens_lens, train: bool = False,
                           dropout_rate=0.0, batch_count=None,
                           gens: Optional[TrainGenerators] = None):
        """The text encoder's embeddings plus each position's speaker
        embedding (none at pads), added in the encoder's output dtype."""
        embed = super().forward_text_embed(
            tokens, tokens_lens, train=train, dropout_rate=dropout_rate,
            batch_count=batch_count, gens=gens,
        )
        spk = self.spk_indices(tokens)
        table = self.spk_embed.weight.to(embed.dtype)
        return embed + torch.where(
            (spk >= 0)[:, :, None], table[spk.clamp(min=0)], 0.0
        )


class ZipVoiceDialogStereo(ZipVoiceDialog):
    """Two-channel dialogue TTS: the two-stream decoder and the
    speaker-exclusive energy loss."""

    def _fm_decoder_dims(self, feat_dim: int):
        return (feat_dim * 5, feat_dim * 3), (feat_dim * 2, feat_dim)

    def energy_based_loss(self, fbank1: torch.Tensor, fbank2: torch.Tensor,
                          gt_fbank: torch.Tensor) -> torch.Tensor:
        """(B, T) penalty where both channels' frame energies (mean
        log-mel) exceed the threshold: the product of the two excesses.
        The threshold is each row's median frame energy of the ground truth
        over the 2T frames of both channels, padding included, linearly
        interpolated as ``jnp.quantile`` does (taken in f32)."""
        F = self.feat_dim
        energy1 = fbank1.mean(dim=-1)
        energy2 = fbank2.mean(dim=-1)
        gt_both = torch.cat([gt_fbank[:, :, :F], gt_fbank[:, :, F:]], dim=1)
        thresholds = torch.quantile(
            gt_both.mean(dim=-1).float(), 0.5, dim=1
        ).to(energy1.dtype)[:, None]
        both = ((energy1 > thresholds) & (energy2 > thresholds)).to(
            fbank1.dtype
        )
        return both * (energy1 - thresholds) * (energy2 - thresholds)

    def forward(
        self,
        tokens: torch.Tensor,
        tokens_lens: torch.Tensor,
        features: torch.Tensor,
        features_lens: torch.Tensor,
        noise: torch.Tensor,
        t: torch.Tensor,
        condition_drop_mask: Optional[torch.Tensor] = None,
        speech_condition_mask: Optional[torch.Tensor] = None,
        gens: Optional[TrainGenerators] = None,
        train: bool = True,
        dropout_rate=0.0,
        batch_count=None,
        se_weight: float = 1.0,
    ) -> torch.Tensor:
        """The flow-matching loss, plus ``se_weight`` times the energy
        penalty on the predicted clean features x_t + v (1 - t), averaged
        over the loss mask's frames.  ``features`` is (B, T, 2F) for the
        stereo objective (se_weight > 0) or (B, T, F) mixed-channel
        (se_weight = 0)."""
        xt, vt, loss_mask, fm_loss = self.flow_terms(
            tokens, tokens_lens, features, features_lens, noise, t,
            condition_drop_mask, speech_condition_mask, gens, train,
            dropout_rate, batch_count,
        )
        if se_weight <= 0:
            return fm_loss
        F = self.feat_dim
        target = xt + vt * (1 - t)
        penalty = self.energy_based_loss(
            target[:, :, :F], target[:, :, F:], features
        )
        energy_loss = torch.sum(penalty * loss_mask) / torch.clamp(
            loss_mask.sum(), min=1
        )
        return fm_loss + energy_loss * se_weight
