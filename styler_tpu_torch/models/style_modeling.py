"""Style modeling: encoders -> DAT heads -> length regulation -> prediction
(counterpart of ``styler_tpu/models/style_modeling.py``).

With ``d_target``/``p_target``/``e_target`` the forward is teacher-forced:
the target durations regulate the length, the target pitch and energy
feed the embeddings, and the predictions go to the loss unscaled.

The ``encodings`` dict is the controllability contract:

    t       text encoding                       [B, L, 256]
    t_neck  channel-up text bottleneck          [B, L, 256]
    p_down  raw pitch encoding (pre channel-up) [B, L, 128]
    s_down  pitch-space speaker projection      [B, L, 128]
    d       channel-up duration encoding        [B, L, 256]
    s       speaker encoding                    [B, L, 256]
    e       channel-up energy encoding          [B, L, 256]
    n       channel-up noise encoding           [B, L, 256]

``predict_inference`` runs the predictors, the length regulator and the
embeddings on such encodings after the caller has mixed them (the
inspection grid and mix-and-match of ``synthesis.py``).

The controls (``d_control``, ``p_control``, ``e_control``) are Python
floats or 0-d float32 tensors on the model's device: a CUDA graph captured
with tensor controls reads them at every replay, where a float would be
baked into the captured kernels' arguments. Either form multiplies in
float32, so the two give the same bits.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from styler_tpu_torch.core.config import Config
from styler_tpu_torch.dsp.features import (
    bucketize,
    energy_bin_edges,
    pitch_bin_edges,
    quantize_one_hot,
)
from styler_tpu_torch.models.audio_encoder import AudioEncoder
from styler_tpu_torch.models.predictors import AugmentationClassifier, StylePredictor
from styler_tpu_torch.models.transformer import TextEncoder
from styler_tpu_torch.ops.masking import mask_from_lengths
from styler_tpu_torch.ops.regulate import length_regulate
from styler_tpu_torch.textproc.symbols import VOCAB_SIZE

#: a control: a Python float or a 0-d float32 tensor (module docstring)
Control = Union[float, torch.Tensor]


class ChannelUp(nn.Module):
    """Linear -> ReLU -> Linear -> ReLU (reference modules.py:250-271)."""

    def __init__(self, in_dim: int, hidden: int = 256):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, hidden)

    def forward(self, x):
        return F.relu(self.fc2(F.relu(self.fc1(x))))


class StyleModelingOutput(NamedTuple):
    encoder_output: torch.Tensor  # [B, M, 256] summed style/text encoding
    noise_encoding: torch.Tensor  # [B, M, 256] frame-domain noise encoding
    log_d_prediction: torch.Tensor  # [B, L]
    p_prediction: torch.Tensor  # [B, M]
    e_prediction: torch.Tensor  # [B, M]
    mel_len: torch.Tensor  # [B]
    mel_mask: torch.Tensor  # [B, M]
    dat_posteriors: tuple  # 3 x [B, 2]
    encodings: dict  # controllability contract (module docstring)


class StyleModeling(nn.Module):
    def __init__(self, config: Config):
        super().__init__()
        cfg = self.config = config
        h = cfg.encoder_hidden
        self.text_encoder = TextEncoder(
            vocab_size=VOCAB_SIZE,
            max_seq_len=cfg.max_seq_len,
            d_model=h,
            n_layers=cfg.encoder_layer,
            n_head=cfg.encoder_head,
            d_inner=cfg.fft_conv1d_filter_size,
            kernel_sizes=tuple(cfg.fft_conv1d_kernel_size),
            dropout=cfg.encoder_dropout,
        )
        self.audio_encoder = AudioEncoder(
            n_mel_channels=cfg.n_mel_channels,
            dim_f0=cfg.va_dim_f0,
            dim_energy=cfg.va_dim_energy,
            enc_dim_d=cfg.va_enc_dim_d,
            enc_dim_p=cfg.va_enc_dim_p,
            enc_dim_e=cfg.va_enc_dim_e,
            enc_dim_r=cfg.va_enc_dim_r,
            neck_d=cfg.va_neck_hidden_d,
            neck_p=cfg.va_neck_hidden_p,
            neck_e=cfg.va_neck_hidden_e,
            neck_r=cfg.va_neck_hidden_r,
            chs_grp=cfg.va_chs_grp,
        )
        self.text_linear_down = nn.Linear(h, cfg.va_neck_hidden_t)
        self.speaker_linear_p = nn.Linear(cfg.speaker_embed_dim, cfg.va_neck_hidden_p * 2)
        self.speaker_linear = nn.Linear(cfg.speaker_embed_dim, h)

        self.augmentation_classifier_d = AugmentationClassifier(2 * cfg.va_neck_hidden_d, h)
        self.augmentation_classifier_p = AugmentationClassifier(2 * cfg.va_neck_hidden_p, h)
        self.augmentation_classifier_e = AugmentationClassifier(2 * cfg.va_neck_hidden_e, h)

        self.duration_linear = ChannelUp(2 * cfg.va_neck_hidden_d, h)
        self.pitch_linear = ChannelUp(2 * cfg.va_neck_hidden_p, h)
        self.energy_linear = ChannelUp(2 * cfg.va_neck_hidden_e, h)
        self.residual_linear = ChannelUp(2 * cfg.va_neck_hidden_r, h)
        # single Linear+ReLU, unlike the 2-layer channel-ups
        # (reference modules.py:270-271)
        self.text_linear_up = nn.Linear(cfg.va_neck_hidden_t, h)

        def predictor():
            return StylePredictor(
                h, cfg.style_predictor_filter_size, cfg.style_predictor_kernel_size,
                cfg.style_predictor_dropout,
            )

        self.duration_predictor = predictor()
        self.pitch_predictor = predictor()
        self.energy_predictor = predictor()

        self.pitch_embedding = nn.Embedding(cfg.n_bins, h)
        self.energy_embedding = nn.Embedding(cfg.n_bins, h)
        self.register_buffer(
            "pitch_bins",
            torch.from_numpy(pitch_bin_edges(cfg.f0_min, cfg.f0_max, cfg.n_bins)),
            persistent=False,
        )
        self.register_buffer(
            "energy_bins",
            torch.from_numpy(energy_bin_edges(cfg.energy_min, cfg.energy_max, cfg.n_bins)),
            persistent=False,
        )

    def encoder_input_cat(self, mel_target, p_norm, e_input, mel_aug):
        """[clean mel | f0 one-hot | energy one-hot | aug mel] — 674 channels
        (reference modules.py:218-223)."""
        p_q = quantize_one_hot(p_norm, self.config.n_bins)
        e_q = quantize_one_hot(e_input, self.config.n_bins)
        return torch.cat([mel_target, p_q, e_q, mel_aug], dim=-1)

    def encode_audio(self, enc_cat, mel_len, src_len, max_src: int):
        """Audio-branch encodings in the phoneme domain."""
        return self.audio_encoder(enc_cat, mel_len, src_len, max_src)

    def classify_augmentation(self, d_enc, p_enc, e_enc, src_mask):
        return (
            self.augmentation_classifier_d(d_enc, src_mask),
            self.augmentation_classifier_p(p_enc, src_mask),
            self.augmentation_classifier_e(e_enc, src_mask),
        )

    def duration_rounded(self, log_d_prediction, d_control: Control):
        """round(exp(ld) - log_offset) (half to even) * d_control, >= 0, int."""
        rounded = torch.round(torch.exp(log_d_prediction) - self.config.log_offset)
        return torch.clamp(rounded * d_control, min=0.0).to(torch.int32)

    def forward(
        self,
        src_seq, speaker_embed, mel_target, mel_aug, p_norm, e_input,
        src_len, mel_len, src_mask, max_mel_len: int,
        d_control: Control = 1.0, p_control: Control = 1.0, e_control: Control = 1.0,
        mel_mask: Optional[torch.Tensor] = None,
        d_target: Optional[torch.Tensor] = None,
        p_target: Optional[torch.Tensor] = None,
        e_target: Optional[torch.Tensor] = None,
        dropout: Optional[torch.Generator] = None,
    ) -> StyleModelingOutput:
        """Forward with predicted durations, pitch and energy, or teacher
        forced where a target is given (``mel_mask`` is then the caller's).
        ``dropout``: the step's generator, ``None`` for no dropout."""
        L = src_seq.shape[1]
        h = self.config.encoder_hidden

        text_encoding = self.text_encoder(src_seq, src_mask, dropout)
        text_neck_down = F.relu(self.text_linear_down(text_encoding))
        speaker_p = F.relu(self.speaker_linear_p(speaker_embed))  # [B, 128]
        speaker = F.relu(self.speaker_linear(speaker_embed))  # [B, 256]

        enc_cat = self.encoder_input_cat(mel_target, p_norm, e_input, mel_aug)
        d_enc, p_enc, e_enc, n_enc = self.encode_audio(enc_cat, mel_len, src_len, L)

        dat_posteriors = self.classify_augmentation(d_enc, p_enc, e_enc, src_mask)

        speaker_t = speaker[:, None, :].expand(-1, L, -1)
        speaker_p_t = speaker_p[:, None, :].expand(-1, L, -1)
        pitch_down = p_enc
        p_enc = p_enc + speaker_p_t

        duration_up = self.duration_linear(d_enc)
        pitch_up = self.pitch_linear(p_enc)
        energy_up = self.energy_linear(e_enc)
        noise_up = self.residual_linear(n_enc)[:, :L]
        text_neck = F.relu(self.text_linear_up(text_neck_down))

        encodings = {
            "t": text_encoding,
            "t_neck": text_neck,
            "p_down": pitch_down,
            "s_down": speaker_p_t,
            "d": duration_up,
            "s": speaker_t,
            "e": energy_up,
            "n": noise_up,
        }

        streams = torch.cat(
            [text_encoding, text_neck + pitch_up, speaker_t, text_neck + energy_up, noise_up],
            dim=-1,
        )

        log_d_prediction = self.duration_predictor(text_neck + duration_up, src_mask, dropout)
        if d_target is not None:
            streams, out_mel_len = length_regulate(streams, d_target, max_mel_len)
            out_mel_mask = mel_mask
        else:
            streams, out_mel_len = length_regulate(
                streams, self.duration_rounded(log_d_prediction, d_control), max_mel_len
            )
            out_mel_len = torch.clamp(out_mel_len, max=max_mel_len)
            out_mel_mask = mask_from_lengths(out_mel_len, max_mel_len)

        text_f, pitch_f, speaker_f, energy_f, noise_f = torch.split(streams, h, dim=-1)

        # the bin lookups carry no gradient: the embeddings learn from the
        # targets, the predictors from the loss on their unscaled outputs
        e_prediction = self.energy_predictor(energy_f, out_mel_mask, dropout)
        if e_target is None:
            e_prediction = e_prediction * e_control
        energy_embedding = self.energy_embedding(
            bucketize(e_prediction if e_target is None else e_target, self.energy_bins)
        )

        p_prediction = self.pitch_predictor(pitch_f + speaker_f, out_mel_mask, dropout)
        if p_target is None:
            p_prediction = p_prediction * p_control
        pitch_embedding = self.pitch_embedding(
            bucketize(p_prediction if p_target is None else p_target, self.pitch_bins)
        )

        return StyleModelingOutput(
            encoder_output=text_f + pitch_embedding + speaker_f + energy_embedding,
            noise_encoding=noise_f,
            log_d_prediction=log_d_prediction,
            p_prediction=p_prediction,
            e_prediction=e_prediction,
            mel_len=out_mel_len,
            mel_mask=out_mel_mask,
            dat_posteriors=dat_posteriors,
            encodings=encodings,
        )

    def predict_inference(
        self,
        text_encoding, pitch_encoding, energy_encoding, duration_encoding,
        speaker_encoding, noise_encoding, src_mask, max_mel_len: int,
        speaker_normalized: Union[bool, torch.Tensor] = True,
        d_control: Control = 1.0, p_control: Control = 1.0, e_control: Control = 1.0,
    ):
        """Inference over externally mixed encodings, all [B, L, 256]
        (reference modules.py:285-309). ``speaker_normalized``: a bool, or
        per-row float weights [B] where 1.0 adds the speaker stream to the
        pitch predictor's input (= ``False``) and 0.0 leaves it out, so rows
        with either flag run in one batch.

        Returns (text_f, pitch_embedding, speaker_f, energy_embedding,
        noise_f, log_d_prediction, p_prediction, e_prediction, mel_mask)."""
        streams = torch.cat(
            [text_encoding, pitch_encoding, speaker_encoding, energy_encoding, noise_encoding],
            dim=-1,
        )
        log_d_prediction = self.duration_predictor(duration_encoding, src_mask)
        streams, mel_len = length_regulate(
            streams, self.duration_rounded(log_d_prediction, d_control), max_mel_len
        )
        mel_mask = mask_from_lengths(torch.clamp(mel_len, max=max_mel_len), max_mel_len)
        text_f, pitch_f, speaker_f, energy_f, noise_f = torch.split(
            streams, self.config.encoder_hidden, dim=-1
        )

        e_prediction = self.energy_predictor(energy_f, mel_mask) * e_control
        energy_embedding = self.energy_embedding(bucketize(e_prediction, self.energy_bins))

        if isinstance(speaker_normalized, (bool, int)):
            pitch_in = pitch_f if speaker_normalized else pitch_f + speaker_f
        else:
            w = torch.as_tensor(speaker_normalized, dtype=pitch_f.dtype, device=pitch_f.device)
            pitch_in = pitch_f + w.reshape(-1, 1, 1) * speaker_f
        p_prediction = self.pitch_predictor(pitch_in, mel_mask) * p_control
        pitch_embedding = self.pitch_embedding(bucketize(p_prediction, self.pitch_bins))

        return (
            text_f, pitch_embedding, speaker_f, energy_embedding, noise_f,
            log_d_prediction, p_prediction, e_prediction, mel_mask,
        )
