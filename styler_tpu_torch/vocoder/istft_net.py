"""iSTFTNet generator, inference (counterpart of
``styler_tpu/vocoder/istft_net.py``: ``ISTFTNetConfig``, the generator as
``istft_apply_fused`` runs it, and ``inverse_stft``).

C8C8I topology: conv_pre, two 8x transposed-conv upsample stages each
followed by a resblock stage (kernel A, ``ops/resblock.py``), then
conv_post -> magnitude/phase -> a 16-point inverse STFT with hop 4.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from styler_tpu_torch.dsp.mel import hann_periodic
from styler_tpu_torch.ops.resblock import fused_resblock_stage
from styler_tpu_torch.vocoder.hifigan import LRELU_SLOPE, ConvTranspose1dTorch, ResBlock1


@dataclasses.dataclass(frozen=True)
class ISTFTNetConfig:
    """C8C8I topology: 8x8 conv upsampling + 4x via iSTFT (hop 4)."""

    upsample_rates: Tuple[int, ...] = (8, 8)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    istft_n_fft: int = 16
    istft_hop: int = 4
    num_mels: int = 80


def inverse_stft(mag: torch.Tensor, phase: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[B, T, n_fft//2+1] magnitude/phase -> wav [B, T*hop]: windowed irfft
    per frame, overlap-add, window-square (COLA) division, center crop of
    n_fft//2 (torch.istft(center=True) framing). Requires hop | n_fft."""
    if n_fft % hop:
        raise ValueError("hop must divide n_fft")
    B, T, _ = mag.shape
    window = torch.from_numpy(hann_periodic(n_fft)).float().to(mag.device)
    frames = torch.fft.irfft(torch.polar(mag, phase), n=n_fft, dim=-1) * window
    L = (T - 1) * hop + n_fft
    out = torch.zeros(B, L, device=mag.device, dtype=torch.float32)
    wsum = np.zeros(L, np.float64)
    w2 = hann_periodic(n_fft) ** 2
    for c in range(n_fft // hop):
        seg = frames[:, :, c * hop : (c + 1) * hop].reshape(B, T * hop)
        out[:, c * hop : c * hop + T * hop] += seg
        wsum[c * hop : c * hop + T * hop] += np.tile(w2[c * hop : (c + 1) * hop], T)
    out = out / torch.from_numpy(np.maximum(wsum, 1e-9).astype(np.float32)).to(mag.device)
    return out[:, n_fft // 2 : n_fft // 2 + T * hop]


class ISTFTNetGenerator(nn.Module):
    """mel [B, T, 80] (natural-log mel, channels-last) -> wav [B, T*256].

    ``compute_dtype`` (bfloat16 by default, as the reference's
    ``make_generator``) is the dtype of every conv's inputs; the resblock
    stages keep their residual carry in f32 (kernel A)."""

    def __init__(self, config: ISTFTNetConfig = ISTFTNetConfig(), compute_dtype=torch.bfloat16):
        super().__init__()
        cfg = self.config = config
        self.compute_dtype = compute_dtype
        ch = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, ch, 7, padding=3)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            self.add_module(f"ups_{i}", ConvTranspose1dTorch(ch, ch // 2, k, u))
            ch //= 2
            for j, (rk, rd) in enumerate(
                zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)
            ):
                self.add_module(f"resblocks_{i}_{j}", ResBlock1(ch, rk, tuple(rd)))
        self.n_bins = cfg.istft_n_fft // 2 + 1
        self.conv_post = nn.Conv1d(ch, 2 * self.n_bins, 7, padding=3)

    def _conv(self, conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv1d(x.transpose(1, 2).to(dt), conv.weight.to(dt), conv.bias.to(dt),
                     padding=conv.padding)
        return y.transpose(1, 2)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        x = self._conv(self.conv_pre, mel)
        for i in range(len(cfg.upsample_rates)):
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, LRELU_SLOPE))
            blocks = [
                getattr(self, f"resblocks_{i}_{j}")
                for j in range(len(cfg.resblock_kernel_sizes))
            ]
            x = fused_resblock_stage(
                x.contiguous(),
                [blk.branch_params() for blk in blocks],
                kernel_sizes=tuple(cfg.resblock_kernel_sizes),
                dilations=tuple(cfg.resblock_dilation_sizes[0]),
            )
        # conv_post follows F.leaky_relu's default slope 0.01, not 0.1
        x = self._conv(self.conv_post, F.leaky_relu(x, 0.01)).float()
        mag = torch.exp(torch.clamp(x[..., : self.n_bins], -12.0, 8.0))
        phase = x[..., self.n_bins :]
        return inverse_stft(mag, phase, cfg.istft_n_fft, cfg.istft_hop)
