"""The HiFi-GAN pieces the iSTFTNet generator shares (counterpart of
``styler_tpu/vocoder/hifigan.py``: ``ConvTranspose1dTorch``, ``ResBlock1``,
``LRELU_SLOPE``). The HiFi-GAN generator itself is a later slice."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

LRELU_SLOPE = 0.1


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
