"""STYLER top model, eval forward (counterpart of
``styler_tpu/models/styler.py``): style modeling -> shared decoder ->
clean and residual ("noisy") decodes as one 2B batch."""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn as nn

from styler_tpu_torch.core.config import Config
from styler_tpu_torch.models.style_modeling import StyleModeling
from styler_tpu_torch.models.transformer import MelDecoder, PostNet
from styler_tpu_torch.ops.masking import mask_from_lengths


class StylerOutput(NamedTuple):
    mel: torch.Tensor  # [B, M, 80] clean decode
    mel_noisy: torch.Tensor  # [B, M, 80] residual (noisy) decode
    mel_postnet: torch.Tensor
    mel_postnet_noisy: torch.Tensor
    log_d_prediction: torch.Tensor  # [B, L]
    p_prediction: torch.Tensor  # [B, M]
    e_prediction: torch.Tensor  # [B, M]
    src_mask: torch.Tensor  # [B, L] True at padding
    mel_mask: torch.Tensor  # [B, M]
    mel_len: torch.Tensor  # [B]
    dat_posteriors: tuple  # 3 x [B, 2]
    encodings: dict  # controllability contract


class STYLER(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        if config.compute_dtype != "float32":
            raise NotImplementedError(
                "the port's acoustic model runs float32 only; a bfloat16 "
                "acoustic model is a later slice (ROADMAP.md)"
            )
        self.config = config
        self.style_modeling = StyleModeling(config)
        self.decoder = MelDecoder(
            max_seq_len=config.max_seq_len,
            d_model=config.decoder_hidden,
            n_layers=config.decoder_layer,
            n_head=config.decoder_head,
            d_inner=config.fft_conv1d_filter_size,
            kernel_sizes=tuple(config.fft_conv1d_kernel_size),
        )
        self.mel_linear = nn.Linear(config.decoder_hidden, config.n_mel_channels)
        self.postnet = PostNet(n_mel_channels=config.n_mel_channels)

    def decode(self, style_output: torch.Tensor, mel_mask: torch.Tensor):
        """Decoder -> mel projection -> PostNet residual (styler.py:29-37)."""
        mel = self.mel_linear(self.decoder(style_output, mel_mask))
        return mel, self.postnet(mel) + mel

    def forward(
        self,
        src_seq: torch.Tensor,
        mel_target: torch.Tensor,
        mel_aug: torch.Tensor,
        p_norm: torch.Tensor,
        e_input: torch.Tensor,
        src_len: torch.Tensor,
        mel_len: torch.Tensor,
        max_mel_len: int,
        speaker_embed: torch.Tensor,
        d_control: float = 1.0,
        p_control: float = 1.0,
        e_control: float = 1.0,
    ) -> StylerOutput:
        src_mask = mask_from_lengths(src_len, src_seq.shape[1])
        sm = self.style_modeling(
            src_seq, speaker_embed, mel_target, mel_aug, p_norm, e_input,
            src_len, mel_len, src_mask, max_mel_len, d_control, p_control, e_control,
        )
        # Residual decoding: the noisy decode reads the style output plus
        # the noise encoding; in eval both run as one 2B batch through the
        # shared decoder (batch-independent math, running-average BN).
        B = sm.encoder_output.shape[0]
        stacked = torch.cat([sm.encoder_output, sm.encoder_output + sm.noise_encoding], dim=0)
        mel2, mel_postnet2 = self.decode(stacked, torch.cat([sm.mel_mask, sm.mel_mask], dim=0))
        return StylerOutput(
            mel=mel2[:B],
            mel_noisy=mel2[B:],
            mel_postnet=mel_postnet2[:B],
            mel_postnet_noisy=mel_postnet2[B:],
            log_d_prediction=sm.log_d_prediction,
            p_prediction=sm.p_prediction,
            e_prediction=sm.e_prediction,
            src_mask=src_mask,
            mel_mask=sm.mel_mask,
            mel_len=sm.mel_len,
            dat_posteriors=sm.dat_posteriors,
            encodings=sm.encodings,
        )
