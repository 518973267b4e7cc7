"""Neural vocoders (mel -> waveform), counterpart of
``styler_tpu/vocoder/__init__.py``.

The reference selects a vocoder with ``hp.vocoder`` in {"HiFi-GAN",
"MelGAN", "WaveGlow"}; iSTFTNet is the JAX package's own fast vocoder. The
port builds HiFi-GAN and iSTFTNet; MelGAN and WaveGlow are a later slice.
"""

import torch

from styler_tpu_torch.vocoder.hifigan import Generator, HiFiGANConfig, vocode  # noqa: F401
from styler_tpu_torch.vocoder.istft_net import ISTFTNetConfig, ISTFTNetGenerator  # noqa: F401

VOCODERS = ("HiFi-GAN", "MelGAN", "WaveGlow", "iSTFTNet")


def make_generator(name: str = "HiFi-GAN", compute_dtype=torch.bfloat16, quantize: bool = False):
    """Vocoder factory keyed on the reference's ``hp.vocoder`` names.

    Every generator maps a natural-log mel [B, T, 80] to a waveform
    [B, T*256] in [-1, 1]. ``quantize`` (kernel A's int8 form) applies to
    HiFi-GAN only and is ignored for iSTFTNet, as in the JAX package.
    """
    if name == "HiFi-GAN":
        return Generator(compute_dtype=compute_dtype, quantize=quantize)
    if name == "iSTFTNet":
        return ISTFTNetGenerator(compute_dtype=compute_dtype)
    if name in ("MelGAN", "WaveGlow"):
        raise NotImplementedError(
            f"vocoder {name!r} is a later slice of the port (ROADMAP.md, Queue 1 item 15)"
        )
    raise ValueError(f"unknown vocoder {name!r}; supported: {VOCODERS}")
