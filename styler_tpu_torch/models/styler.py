"""STYLER top model (counterpart of ``styler_tpu/models/styler.py``):
style modeling -> shared decoder -> clean and residual ("noisy") decodes.

"Residual Decoding": the clean mel is decoded from the style-modeling
output, the noisy mel from ``style_output.detach() + noise_encoding``, so
the noise branch learns the residual without sending gradients into the
style factors. In eval mode the two decodes run as one 2B batch; in train
mode (``nn.Module.train()``) they stay two sequential passes, so the
PostNet's BatchNorm sees the batch statistics, and makes the two momentum
updates, of the reference's two forwards. Dropout is a separate switch:
the ``dropout`` generator argument, ``None`` for none. ``residual=False``
skips the residual decode.

``config.compute_dtype = "bfloat16"`` is the JAX package's mixed
precision: the sites that take flax's ``dtype=`` there compute in
bfloat16 here (``models/transformer.py``), everything else in float32;
the parameters stay float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from styler_tpu_torch.core.config import Config
from styler_tpu_torch.models.style_modeling import Control, StyleModeling
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
        if config.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype {config.compute_dtype!r}: float32 or bfloat16")
        self.config = config
        self.style_modeling = StyleModeling(config)
        self.decoder = MelDecoder(
            max_seq_len=config.max_seq_len,
            d_model=config.decoder_hidden,
            n_layers=config.decoder_layer,
            n_head=config.decoder_head,
            d_inner=config.fft_conv1d_filter_size,
            kernel_sizes=tuple(config.fft_conv1d_kernel_size),
            dropout=config.decoder_dropout,
            compute_dtype=config.model_dtype,
        )
        # the mel projection stays float32 in the bfloat16 mode
        self.mel_linear = nn.Linear(config.decoder_hidden, config.n_mel_channels)
        self.postnet = PostNet(n_mel_channels=config.n_mel_channels,
                               compute_dtype=config.model_dtype)

    def decode(self, style_output: torch.Tensor, mel_mask: torch.Tensor,
               dropout: Optional[torch.Generator] = None):
        """Decoder -> mel projection -> PostNet residual (styler.py:29-37)."""
        mel = self.mel_linear(self.decoder(style_output, mel_mask, dropout))
        return mel, self.postnet(mel, dropout) + mel

    def encode_style(self, src_seq, mel_target, mel_aug, p_norm, e_input, src_len, mel_len,
                     max_mel_len: int, speaker_embed,
                     d_control: Control = 1.0, p_control: Control = 1.0,
                     e_control: Control = 1.0):
        """The style-modeling forward with predicted durations and no
        decode: the encodings producer of the inspection grid and of
        mix-and-match, which decode mixed encodings of their own.

        Returns ``(encodings dict, src_mask, predicted mel_len)``."""
        src_mask = mask_from_lengths(src_len, src_seq.shape[1])
        sm = self.style_modeling(
            src_seq, speaker_embed, mel_target, mel_aug, p_norm, e_input,
            src_len, mel_len, src_mask, max_mel_len, d_control, p_control, e_control,
        )
        return sm.encodings, src_mask, sm.mel_len

    def forward_dat(self, mel_aug, f0_norm_aug, e_input_aug, mel_len, src_len, src_mask):
        """Second DAT pass on fully augmented inputs (reference
        train.py:148-156): encoder_input_cat(aug, aug, aug, aug) -> audio
        encoder -> the three augmentation classifiers, to be scored
        against label 1."""
        sm = self.style_modeling
        enc_cat = sm.encoder_input_cat(mel_aug, f0_norm_aug, e_input_aug, mel_aug)
        d_enc, p_enc, e_enc, _ = sm.encode_audio(enc_cat, mel_len, src_len, src_mask.shape[1])
        return sm.classify_augmentation(d_enc, p_enc, e_enc, src_mask)

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
        d_control: Control = 1.0,
        p_control: Control = 1.0,
        e_control: Control = 1.0,
        d_target: Optional[torch.Tensor] = None,
        p_target: Optional[torch.Tensor] = None,
        e_target: Optional[torch.Tensor] = None,
        dropout: Optional[torch.Generator] = None,
        residual: bool = True,
    ) -> StylerOutput:
        """``residual=False`` decodes the clean path only (B rows, not 2B):
        for callers that use only the denoised output. The noisy slots then
        hold the clean tensors, so the output's fields keep their shapes."""
        src_mask = mask_from_lengths(src_len, src_seq.shape[1])
        mel_mask = mask_from_lengths(mel_len, max_mel_len) if d_target is not None else None
        sm = self.style_modeling(
            src_seq, speaker_embed, mel_target, mel_aug, p_norm, e_input,
            src_len, mel_len, src_mask, max_mel_len, d_control, p_control, e_control,
            mel_mask, d_target, p_target, e_target, dropout,
        )
        # teacher forced: the output mask and lengths are the caller's
        out_mel_mask = sm.mel_mask if d_target is None else mel_mask
        out_mel_len = sm.mel_len if d_target is None else mel_len
        noisy_in = sm.encoder_output.detach() + sm.noise_encoding
        if not residual:
            mel, mel_postnet = self.decode(sm.encoder_output, out_mel_mask, dropout)
            mel_noisy, mel_postnet_noisy = mel, mel_postnet
        elif self.training:
            mel, mel_postnet = self.decode(sm.encoder_output, out_mel_mask, dropout)
            mel_noisy, mel_postnet_noisy = self.decode(noisy_in, out_mel_mask, dropout)
        else:
            # one 2B batch through the shared decoder (batch-independent
            # math, running-average BN)
            B = sm.encoder_output.shape[0]
            mel2, mel_postnet2 = self.decode(
                torch.cat([sm.encoder_output, noisy_in], dim=0),
                torch.cat([out_mel_mask, out_mel_mask], dim=0), dropout,
            )
            mel, mel_noisy = mel2[:B], mel2[B:]
            mel_postnet, mel_postnet_noisy = mel_postnet2[:B], mel_postnet2[B:]
        return StylerOutput(
            mel=mel,
            mel_noisy=mel_noisy,
            mel_postnet=mel_postnet,
            mel_postnet_noisy=mel_postnet_noisy,
            log_d_prediction=sm.log_d_prediction,
            p_prediction=sm.p_prediction,
            e_prediction=sm.e_prediction,
            src_mask=src_mask,
            mel_mask=out_mel_mask,
            mel_len=out_mel_len,
            dat_posteriors=sm.dat_posteriors,
            encodings=sm.encodings,
        )
