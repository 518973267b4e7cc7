"""Immutable configuration for styler_tpu_torch (a copy of the JAX
package's ``core/config.py``; the port imports nothing of that package).

Parameter names and default values form the compatibility contract with the
reference implementation's flat ``hparams.py`` module (reference
hparams.py:1-114). Unlike the reference — which mutates module globals at
runtime (train.py:383-386, synthesize.py:476-480) — this is a frozen
dataclass; CLI overrides produce a *new* config via ``replace``.

TPU-specific additions live in their own section at the bottom
(shape buckets, mesh axes, dtypes); everything above it matches the
reference names one-to-one so a reference user can map their settings over
directly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    # ------------------------------------------------------------------
    # Dataset (reference hparams.py:3-6)
    # ------------------------------------------------------------------
    dataset: str = "VCTK"
    data_dir: str = "/path/to/VCTK-Corpus-92/wav48_silence_trimmed"
    noise_dir: str = "/path/to/wham_noise"

    # Speaker embedding (hparams.py:8-10)
    speaker_embed_dim: int = 512
    speaker_embedder_dir: str = (
        "deepspeaker/pretrained_models/ResCNN_triplet_training_checkpoint_265.h5"
    )

    # Version control (hparams.py:12-13)
    version: str = ""

    # Text (hparams.py:15-16)
    text_cleaners: Tuple[str, ...] = ("english_cleaners",)

    # Vocoder (hparams.py:18-20)
    vocoder: str = "HiFi-GAN"
    vocoder_speaker: str = "universal"

    # Quantization range for f0 and energy (hparams.py:22-26)
    f0_min: float = 71.0
    f0_max: float = 797.9
    energy_min: float = 0.1
    energy_max: float = 525.43

    # Audio and mel (hparams.py:28-39)
    sampling_rate: int = 22050
    filter_length: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_bins: int = 256
    max_wav_value: float = 32768.0
    n_mel_channels: int = 80
    mel_fmin: float = 0.0
    mel_fmax: float = 8000.0

    # STYLER model dims (hparams.py:42-76)
    encoder_layer: int = 2
    encoder_head: int = 4
    encoder_hidden: int = 256
    decoder_layer: int = 4
    decoder_head: int = 4
    decoder_hidden: int = 256
    fft_conv1d_filter_size: int = 1024
    fft_conv1d_kernel_size: Tuple[int, int] = (9, 1)
    encoder_dropout: float = 0.2
    decoder_dropout: float = 0.2

    style_predictor_filter_size: int = 256
    style_predictor_kernel_size: int = 3
    style_predictor_dropout: float = 0.5

    max_seq_len: int = 1000

    dat_weight: float = 1.0
    max_mel_len: int = 1024

    va_neck_hidden_t: int = 4
    va_neck_hidden_r: int = 64
    va_neck_hidden_d: int = 80
    va_neck_hidden_p: int = 64
    va_neck_hidden_e: int = 64

    va_enc_dim_r: int = 256
    va_enc_dim_d: int = 256
    va_enc_dim_p: int = 320
    va_enc_dim_e: int = 320

    va_dim_f0: int = 257
    va_dim_energy: int = 257
    va_chs_grp: int = 16

    # Paths (hparams.py:79-90); resolved lazily via properties below.
    preprocessed_basedir: str = "preprocessed"
    ref_audio_dir: str = "/path/to/ref_audio"
    ref_tg_dir: str = os.path.join("preprocessed", "ref_audio", "TextGrid")

    # Optimizer (hparams.py:92-101)
    batch_size: int = 16
    epochs: int = 500
    n_warm_up_step: int = 4000
    grad_clip_thresh: float = 1.0
    acc_steps: int = 1
    betas: Tuple[float, float] = (0.9, 0.98)
    eps: float = 1e-9
    weight_decay: float = 0.0

    # Log-scaled duration (hparams.py:104-105)
    log_offset: float = 1.0

    # Save, log and synthesis cadences (hparams.py:108-114)
    save_step: int = 10000
    synth_step: int = 1000
    eval_step: int = 1000
    eval_size: int = 2000
    log_step: int = 1000
    clear_time: int = 20

    # ------------------------------------------------------------------
    # TPU-native additions (no reference counterpart)
    # ------------------------------------------------------------------
    # Val batches per eval_step: 0 = the full split (reference
    # evaluate.py:27-142 walks the whole val set); set small (e.g. 8)
    # for smoke runs.
    eval_batches: int = 0
    # Static padded shape buckets (phoneme axis / mel-frame axis). All
    # jitted paths pad to one of these to bound XLA recompilation.
    src_buckets: Tuple[int, ...] = (32, 64, 128, 192, 256)
    mel_buckets: Tuple[int, ...] = (128, 256, 512, 768, 1024)
    # Device mesh axis names: data-parallel and (optional) model axes.
    mesh_data_axis: str = "data"
    mesh_model_axis: str = "model"
    # Compute dtype for the matmul/conv-heavy model paths; params stay
    # float32 (flax param_dtype default). "bfloat16" is the MXU-native
    # mixed-precision mode (~35% faster train steps on v5e); "float32"
    # is the parity default. Norm layers, LSTMs, the mel calibrator,
    # losses, and the optimizer always run float32.
    compute_dtype: str = "float32"
    # PRNG seed (reference: torch.manual_seed(0), train.py:22).
    seed: int = 0

    # ------------------------------------------------------------------
    # Derived values / path helpers (reference hparams.py:81-86)
    # ------------------------------------------------------------------
    @property
    def preprocessed_path(self) -> str:
        # os.path.join (not an f-string) so an ABSOLUTE basedir is
        # honored — "./" + "/abs/path" would silently turn relative
        return os.path.join(".", self.preprocessed_basedir, self.dataset)

    def checkpoint_path(self) -> str:
        return os.path.join("./ckpt/", self.dataset, self.version)

    def synth_path(self) -> str:
        return os.path.join("./synth/", self.dataset, self.version)

    def eval_path(self) -> str:
        return os.path.join("./eval/", self.dataset, self.version)

    def log_path(self) -> str:
        return os.path.join("./log/", self.dataset, self.version)

    def test_path(self) -> str:
        return os.path.join("./results/", self.dataset, self.version)

    @property
    def n_frames_per_sec(self) -> float:
        """Mel frames per second of audio (RTF denominator)."""
        return self.sampling_rate / self.hop_length

    @property
    def model_dtype(self):
        """`compute_dtype` as a torch dtype."""
        import torch

        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            self.compute_dtype
        ]

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def default_config() -> Config:
    return Config()


def bucket_for(length: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= length (falls back to the largest bucket)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]
