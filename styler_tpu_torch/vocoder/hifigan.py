"""HiFi-GAN V1 generator, inference (counterpart of
``styler_tpu/vocoder/hifigan.py``: ``HiFiGANConfig``, ``ConvTranspose1dTorch``,
``ResBlock1``, ``LRELU_SLOPE``, the generator as ``generator_apply_fused``
runs it, and ``vocode``). iSTFTNet shares the pieces above the generator.

Topology (the reference's universal V1, hifigan/config.json): conv_pre,
4 x (leaky-ReLU 0.1, transposed-conv upsample by 8, 8, 2, 2, resblock stage
at C = 256, 128, 64, 32), leaky-ReLU 0.01, conv_post, tanh. Every resblock
stage runs kernel A (``ops/resblock.py``); with ``quantize=True`` it runs
kernel A's int8 form instead, on weights quantised once per generator.
Weight norm is folded at import (``core/import_torch.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from styler_tpu_torch.ops.resblock import fused_resblock_stage, quantize_branch_params

LRELU_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class HiFiGANConfig:
    """Mirror of hifigan/config.json (universal V1)."""

    resblock: str = "1"
    upsample_rates: Tuple[int, ...] = (8, 8, 2, 2)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16, 4, 4)
    upsample_initial_channel: int = 512
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = (
        (1, 3, 5),
        (1, 3, 5),
        (1, 3, 5),
    )
    num_mels: int = 80
    sampling_rate: int = 22050


class ConvTranspose1dTorch(nn.Module):
    """ConvTranspose1d with stride u and padding (k-u)//2, channels-last.

    ``weight`` is torch's conv_transpose1d layout [in, out, k]; the flax
    module stores it flipped as [k, in, out] (``core/convert.py`` maps
    one to the other). Output length is u*T when k - u is even.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        super().__init__()
        self.stride = stride
        self.padding = (kernel_size - stride) // 2
        self.weight = nn.Parameter(torch.zeros(in_channels, out_channels, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        y = F.conv_transpose1d(
            x.transpose(1, 2), self.weight.to(dt), self.bias.to(dt),
            stride=self.stride, padding=self.padding,
        )
        return y.transpose(1, 2)


class ResBlock1(nn.Module):
    """Parameters of one multi-dilation residual block, stacked over
    dilations in the flax layout that kernel A reads: w1, w2 [n_dil, k, C,
    C] and b1, b2 [n_dil, C] (flax ``convs1_{i}`` / ``convs2_{i}``)."""

    def __init__(self, channels: int, kernel_size: int, dilations: Tuple[int, ...] = (1, 3, 5)):
        super().__init__()
        n = len(dilations)
        self.w1 = nn.Parameter(torch.zeros(n, kernel_size, channels, channels))
        self.b1 = nn.Parameter(torch.zeros(n, channels))
        self.w2 = nn.Parameter(torch.zeros(n, kernel_size, channels, channels))
        self.b2 = nn.Parameter(torch.zeros(n, channels))

    def branch_params(self):
        return (self.w1, self.b1, self.w2, self.b2)


class Generator(nn.Module):
    """mel [B, T, 80] (natural-log mel, channels-last) -> wav [B, T*256].

    ``compute_dtype`` (bfloat16 by default, as the reference's
    ``make_generator``) is the dtype of every conv's inputs; the resblock
    stages keep their residual carry in f32 (kernel A). ``quantize=True``
    runs the stages' convolutions as int8 x int8 -> int32 (kernel A's int8
    form); the upsamplers and conv_pre / conv_post stay in compute_dtype.
    Each branch takes its own ``resblock_dilation_sizes`` entry, as the
    flax ``Generator`` does; the kernels run every stage either way.
    """

    def __init__(self, config: HiFiGANConfig = HiFiGANConfig(), compute_dtype=torch.bfloat16,
                 quantize: bool = False):
        super().__init__()
        cfg = self.config = config
        self.compute_dtype = compute_dtype
        self.quantize = quantize
        self._int8 = None  # (device, per-stage quantised branches), made at first int8 use
        ch = cfg.upsample_initial_channel
        self.conv_pre = nn.Conv1d(cfg.num_mels, ch, 7, padding=3)
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            self.add_module(f"ups_{i}", ConvTranspose1dTorch(ch, ch // 2, k, u))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes)):
                self.add_module(f"resblocks_{i}_{j}", ResBlock1(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    def _conv(self, conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv1d(x.transpose(1, 2).to(dt), conv.weight.to(dt), conv.bias.to(dt),
                     padding=conv.padding)
        return y.transpose(1, 2)

    def stage_params(self, i: int):
        """The (w1, b1, w2, b2) of every branch of stage ``i``."""
        return [getattr(self, f"resblocks_{i}_{j}").branch_params()
                for j in range(len(self.config.resblock_kernel_sizes))]

    def int8_params(self, device: torch.device):
        """Every stage's branches quantised for kernel A's int8 form: once
        per generator and device, at the first int8 forward (after the
        weights are loaded)."""
        if self._int8 is None or self._int8[0] != device:
            with torch.no_grad():
                stages = [quantize_branch_params(self.stage_params(i))
                          for i in range(len(self.config.upsample_rates))]
            self._int8 = (device, stages)
        return self._int8[1]

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        ks = tuple(cfg.resblock_kernel_sizes)
        dils = tuple(tuple(d) for d in cfg.resblock_dilation_sizes)
        int8 = self.int8_params(mel.device) if self.quantize else None
        x = self._conv(self.conv_pre, mel)
        for i in range(len(cfg.upsample_rates)):
            x = getattr(self, f"ups_{i}")(F.leaky_relu(x, LRELU_SLOPE)).contiguous()
            params = int8[i] if int8 is not None else self.stage_params(i)
            x = fused_resblock_stage(x, params, ks, dils, quantize=self.quantize)
        # conv_post follows F.leaky_relu's default slope 0.01, not 0.1
        x = self._conv(self.conv_post, F.leaky_relu(x, 0.01))
        return torch.tanh(x.float())[..., 0]


@torch.no_grad()
def vocode(generator: nn.Module, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, T, 80] channels-last -> waveform [B, T*256], no autograd."""
    return generator(mel)
