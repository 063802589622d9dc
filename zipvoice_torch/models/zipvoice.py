"""The ZipVoice flow-matching TTS model in PyTorch (counterpart of
``zipvoice_tpu/models/zipvoice.py``): sampling for inference and the
flow-matching training loss (``forward``).

The model holds ``fm_decoder`` (a U-Net TTSZipformer over [x_t | text
condition | speech condition] predicting the flow velocity),
``text_encoder`` (a small TTSZipformer over token embeddings) and
``embed`` (the token table); its ``state_dict`` is the reference layout.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn

from zipvoice_torch.models.conditioning import (
    condition_time_mask,
    condition_time_mask_draws,
    make_pad_mask,
    upsample_text_embed,
)
from zipvoice_torch.models.solver import euler_sample, euler_step
from zipvoice_torch.models.zipformer import (
    TrainGenerators,
    TTSZipformer,
    set_compute_dtype,
    set_kernel_config,
)
from zipvoice_torch.parallel import mesh
from zipvoice_torch.utils.device import resolve_device


class ZipVoice(nn.Module):
    """ZipVoice base model; the defaults are the published base config."""

    # the training loss's speech-condition span: its share of each row, and
    # whether it is anchored at the row's end (the dialog models) or placed
    # at random
    mask_percent = (0.7, 1.0)
    mask_suffix = False

    def _fm_decoder_dims(self, feat_dim: int):
        """(in_dim, out_dim) of the flow-matching decoder; the stereo model
        returns the two-stream pairs."""
        return feat_dim * 3, feat_dim

    def __init__(
        self,
        fm_decoder_downsampling_factor: Sequence[int] = (1, 2, 4, 2, 1),
        fm_decoder_num_layers: Sequence[int] = (2, 2, 4, 4, 4),
        fm_decoder_cnn_module_kernel: Sequence[int] = (31, 15, 7, 15, 31),
        fm_decoder_feedforward_dim: int = 1536,
        fm_decoder_num_heads: int = 4,
        fm_decoder_dim: int = 512,
        text_encoder_num_layers: int = 4,
        text_encoder_feedforward_dim: int = 512,
        text_encoder_cnn_module_kernel: int = 9,
        text_encoder_num_heads: int = 4,
        text_encoder_dim: int = 192,
        time_embed_dim: int = 192,
        text_embed_dim: int = 192,
        query_head_dim: int = 32,
        value_head_dim: int = 12,
        pos_head_dim: int = 4,
        pos_dim: int = 48,
        feat_dim: int = 100,
        vocab_size: int = 26,
        pad_id: int = 0,
        use_guidance_scale_embed: bool = False,
        guidance_scale_embed_dim: int = 192,
    ):
        super().__init__()
        self.feat_dim = feat_dim
        self.pad_id = pad_id
        self.use_guidance_scale_embed = use_guidance_scale_embed
        shared = dict(
            query_head_dim=query_head_dim, pos_head_dim=pos_head_dim,
            value_head_dim=value_head_dim, pos_dim=pos_dim,
        )
        fm_in, fm_out = self._fm_decoder_dims(feat_dim)
        self.fm_decoder = TTSZipformer(
            in_dim=fm_in,
            out_dim=fm_out,
            downsampling_factor=tuple(fm_decoder_downsampling_factor),
            num_encoder_layers=tuple(fm_decoder_num_layers),
            cnn_module_kernel=tuple(fm_decoder_cnn_module_kernel),
            encoder_dim=fm_decoder_dim,
            feedforward_dim=fm_decoder_feedforward_dim,
            num_heads=fm_decoder_num_heads,
            use_time_embed=True,
            time_embed_dim=time_embed_dim,
            use_guidance_scale_embed=use_guidance_scale_embed,
            guidance_scale_embed_dim=guidance_scale_embed_dim,
            **shared,
        )
        self.text_encoder = TTSZipformer(
            in_dim=text_embed_dim,
            out_dim=feat_dim,
            downsampling_factor=(1,),
            num_encoder_layers=(text_encoder_num_layers,),
            cnn_module_kernel=(text_encoder_cnn_module_kernel,),
            encoder_dim=text_encoder_dim,
            feedforward_dim=text_encoder_feedforward_dim,
            num_heads=text_encoder_num_heads,
            use_time_embed=False,
            **shared,
        )
        self.embed = nn.Embedding(vocab_size, text_embed_dim)

    def forward_fm_decoder(self, t, xt, text_condition, speech_condition,
                           padding_mask=None, guidance_scale=None,
                           train: bool = False, dropout_rate=0.0,
                           batch_count=None,
                           gens: Optional[TrainGenerators] = None):
        """Velocity prediction; t: (B,).  The concatenation promotes to the
        widest input dtype, as JAX's does."""
        xt = torch.cat([xt, text_condition, speech_condition], dim=-1)
        return self.fm_decoder(xt, t=t, padding_mask=padding_mask,
                               guidance_scale=guidance_scale, train=train,
                               dropout_rate=dropout_rate,
                               batch_count=batch_count, gens=gens)

    def forward_text_embed(self, tokens, tokens_lens, train: bool = False,
                           dropout_rate=0.0, batch_count=None,
                           gens: Optional[TrainGenerators] = None):
        """Token ids (B, S), including the trailing pad ``pad_tokens``
        appends, -> text-encoder embeddings (B, S, feat_dim)."""
        mask = make_pad_mask(tokens_lens, tokens.shape[1])
        return self.text_encoder(self.embed(tokens), padding_mask=mask,
                                 train=train, dropout_rate=dropout_rate,
                                 batch_count=batch_count, gens=gens)

    def flow_terms(
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
    ):
        """The training forward up to the loss: (x_t, predicted velocity,
        loss mask (B, T) bool, flow-matching loss).  The loss is the masked
        MSE of the velocity, averaged over the masked frames and the
        features' width.  Arguments as ``forward``'s."""
        T = features.shape[1]
        embed = self.forward_text_embed(
            tokens, tokens_lens, train=train, dropout_rate=dropout_rate,
            batch_count=batch_count, gens=gens,
        )
        text_condition, padding_mask = upsample_text_embed(
            embed, tokens_lens, features_lens, T
        )
        if speech_condition_mask is None:
            total, rows = gens.batch_rows(features.shape[0])
            u_size, u_start = condition_time_mask_draws(
                gens.device, total, features.device)
            speech_condition_mask = condition_time_mask(
                u_size[rows], u_start[rows], features_lens, T,
                mask_percent=self.mask_percent, suffix=self.mask_suffix,
            )
        speech_condition = features.masked_fill(
            speech_condition_mask[:, :, None], 0.0
        )
        if condition_drop_mask is not None:
            text_condition = text_condition.masked_fill(
                condition_drop_mask[:, None, None], 0.0
            )
        xt = features * t + noise * (1 - t)
        ut = features - noise
        vt = self.forward_fm_decoder(
            t.reshape(-1), xt, text_condition, speech_condition,
            padding_mask, train=train, dropout_rate=dropout_rate,
            batch_count=batch_count, gens=gens,
        )
        loss_mask = speech_condition_mask & ~padding_mask
        se = torch.sum(torch.square(vt - ut) * loss_mask[:, :, None])
        # the global batch's count under a process group: each process's
        # loss is then its share of the global loss
        denom = torch.clamp(
            mesh.global_sum(loss_mask.sum()) * vt.shape[-1], min=1)
        return xt, vt, loss_mask, se / denom

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
    ) -> torch.Tensor:
        """The masked-MSE flow-matching training loss, a scalar.

        t: (B, 1, 1) flow time; noise: like features (B, T, F);
        condition_drop_mask: (B,) bool, True drops the text condition (CFG
        training); speech_condition_mask: (B, T) bool span mask, True where
        the speech condition is hidden (and the loss is taken), drawn from
        ``gens.device`` when None (``mask_percent``, ``mask_suffix``).
        ``gens`` also draws the regularizers' coins and masks when
        ``train``; ``batch_count`` drives the schedules."""
        return self.flow_terms(
            tokens, tokens_lens, features, features_lens, noise, t,
            condition_drop_mask, speech_condition_mask, gens, train,
            dropout_rate, batch_count,
        )[-1]

    @torch.no_grad()
    def sample(
        self,
        tokens: torch.Tensor,
        tokens_lens: torch.Tensor,
        prompt_tokens_lens: torch.Tensor,
        prompt_features: torch.Tensor,
        prompt_features_lens: torch.Tensor,
        features_lens: torch.Tensor,
        noise: torch.Tensor,
        num_step: int = 16,
        guidance_scale: float = 1.0,
        t_shift: float = 0.5,
    ):
        """Generate features with static shapes.

        tokens: (B, S) prompt+text ids, padded, incl. the trailing pad;
        prompt_features: (B, T, F) zero-padded to the output length T;
        features_lens: (B,) total (prompt + generated) frame counts;
        noise: (B, T, F) the x0 noise.  ``prompt_tokens_lens`` is part of
        the JAX signature; durations come in through ``features_lens``.

        Returns (x1, padding_mask); ``strip_prompt`` cuts the prompt off.
        """
        text_condition, speech_condition, padding_mask = (
            self.sample_condition(tokens, tokens_lens, prompt_features,
                                  prompt_features_lens, features_lens))
        x1 = euler_sample(
            self.forward_fm_decoder, x=noise, text_condition=text_condition,
            speech_condition=speech_condition, padding_mask=padding_mask,
            num_step=num_step, guidance_scale=guidance_scale,
            t_shift=t_shift, distill=self.use_guidance_scale_embed,
        )
        return x1, padding_mask

    def sample_condition(self, tokens, tokens_lens, prompt_features,
                         prompt_features_lens, features_lens):
        """``sample``'s conditions, (text_condition (B, T, F), speech
        condition (B, T, F), padding mask (B, T)): the text encoder's
        output upsampled to T frames, and the prompt's features with the
        frames past its length zeroed."""
        T = prompt_features.shape[1]
        embed = self.forward_text_embed(tokens, tokens_lens)
        text_condition, padding_mask = upsample_text_embed(
            embed, tokens_lens, features_lens, T
        )
        prompt_mask = make_pad_mask(prompt_features_lens, T)
        speech_condition = prompt_features.masked_fill(
            prompt_mask[:, :, None], 0.0
        )
        return text_condition, speech_condition, padding_mask

    def sample_step(self, x, t, t_next, text_condition, speech_condition,
                    padding_mask, guidance_scale: float = 1.0):
        """One of ``sample``'s Euler steps, x (f32) from ``t`` to
        ``t_next`` (f32 0-dim tensors, or numbers)."""
        return euler_step(
            self.forward_fm_decoder, x.float(), t, t_next, text_condition,
            speech_condition, padding_mask, guidance_scale,
            distill=self.use_guidance_scale_embed,
        )

    def sample_intermediate(
        self,
        tokens: torch.Tensor,
        tokens_lens: torch.Tensor,
        features: torch.Tensor,
        features_lens: torch.Tensor,
        noise: torch.Tensor,
        speech_condition_mask: torch.Tensor,
        t_start,
        t_end,
        num_step: int = 1,
        guidance_scale=0.0,
        distill: Optional[bool] = None,
        train: bool = False,
        dropout_rate=0.0,
        batch_count=None,
        gens: Optional[TrainGenerators] = None,
    ):
        """Partial-trajectory sampling for distillation training
        (reference zipvoice.py:488-534): ``num_step`` Euler steps from
        ``noise`` at ``t_start`` to ``t_end`` (floats or device scalars),
        the speech condition being ``features`` outside
        ``speech_condition_mask``.  ``guidance_scale`` may be (B, 1, 1);
        ``distill`` (the model's own kind by default) makes it a network
        input.  With ``train`` the backbone runs with its regularizers and
        dropout, drawn from ``gens``, as the distillation student does.
        Records gradients unless the caller turns them off.  Returns
        (x at t_end, padding mask)."""
        T = features.shape[1]
        embed = self.forward_text_embed(
            tokens, tokens_lens, train=train, dropout_rate=dropout_rate,
            batch_count=batch_count, gens=gens,
        )
        text_condition, padding_mask = upsample_text_embed(
            embed, tokens_lens, features_lens, T
        )
        speech_condition = features.masked_fill(
            speech_condition_mask[:, :, None], 0.0
        )
        if distill is None:
            distill = self.use_guidance_scale_embed

        def velocity_fn(t, x, tc, sc, pm, gs):
            return self.forward_fm_decoder(
                t, x, tc, sc, pm, guidance_scale=gs, train=train,
                dropout_rate=dropout_rate, batch_count=batch_count,
                gens=gens,
            )

        x = euler_sample(
            velocity_fn, x=noise, text_condition=text_condition,
            speech_condition=speech_condition, padding_mask=padding_mask,
            num_step=num_step, guidance_scale=guidance_scale,
            distill=distill, t_start=t_start, t_end=t_end,
        )
        return x, padding_mask


class ZipVoiceDistill(ZipVoice):
    """Distilled variant: the guidance scale is a network input."""

    def __init__(self, **kwargs):
        kwargs.setdefault("use_guidance_scale_embed", True)
        super().__init__(**kwargs)


def strip_prompt(x1: torch.Tensor, padding_mask: torch.Tensor,
                 prompt_features_lens: torch.Tensor):
    """Split the sampled features into the generated part, shifted to the
    start of the time axis and zero-padded, and its lengths."""
    B, T, F = x1.shape
    wo_prompt_lens = (~padding_mask).sum(dim=-1) - prompt_features_lens
    ar = torch.arange(T, device=x1.device)
    shift = (ar[None, :] + prompt_features_lens[:, None].long()).clamp(
        0, T - 1
    )
    x1_wo = torch.gather(x1, 1, shift[:, :, None].expand(B, T, F))
    valid = ar[None, :] < wo_prompt_lens[:, None]
    return torch.where(valid[:, :, None], x1_wo, 0.0), wo_prompt_lens


def build_zipvoice(distill: bool = False, device="cuda",
                   dtype: torch.dtype = torch.float32, seed: int = 0,
                   train: bool = False, kernel_config: bool = False,
                   model_class=None, **config) -> ZipVoice:
    """A ZipVoice (ZipVoiceDistill with ``distill``; ``model_class``, such
    as a dialog model, when given) with random weights drawn from
    ``seed``, on ``device`` (CUDA unless the caller asks for the CPU), in
    eval mode, with its matmul and conv layers computing in ``dtype``.  For
    inference their weights are cast to ``dtype``; with ``train=True`` every
    weight stays f32 and is cast at use.  ``kernel_config`` switches every
    kernel on (``set_kernel_config``); by default only the attention-weights
    kernels are."""
    device = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if model_class is None:
            model_class = ZipVoiceDistill if distill else ZipVoice
        model = model_class(**config)
    model.to(device).eval()
    for backbone in (model.fm_decoder, model.text_encoder):
        set_compute_dtype(backbone, dtype, cast_weights=not train)
    return set_kernel_config(model, kernel_config)
