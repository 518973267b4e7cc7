"""Gradient-reversal layer for domain-adversarial training (DAT)
(counterpart of ``styler_tpu/ops/grl.py``).

Identity in the forward pass; the backward pass multiplies the incoming
gradient by ``-alpha``, so whatever feeds the layer is trained to defeat
the classifier behind it while the classifier itself gets the true
gradient.
"""

from __future__ import annotations

import torch


class _GradientReversal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, alpha: float) -> torch.Tensor:
        ctx.alpha = alpha
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return -ctx.alpha * g, None


def gradient_reversal(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return _GradientReversal.apply(x, alpha)
