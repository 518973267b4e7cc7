"""Style predictors and domain-adversarial (DAT) classifier heads
(counterpart of ``styler_tpu/models/predictors.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from styler_tpu_torch.models.transformer import LN_EPS, Conv1d, conv1d_cl
from styler_tpu_torch.ops.dropout import dropout as _dropout
from styler_tpu_torch.ops.grl import gradient_reversal


class StylePredictor(nn.Module):
    """2x [Conv1d k3 -> ReLU -> LayerNorm -> dropout] -> Linear -> scalar per
    position, masked to 0 (reference modules.py:426-465). The convs compute
    in ``compute_dtype``; the LayerNorms and the Linear in float32."""

    def __init__(self, in_dim=256, filter_size=256, kernel_size=3, dropout: float = 0.5,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        pad = (kernel_size - 1) // 2
        self.conv1d_1 = Conv1d(in_dim, filter_size, kernel_size, pad, compute_dtype)
        self.layer_norm_1 = nn.LayerNorm(filter_size, eps=LN_EPS)
        self.conv1d_2 = Conv1d(filter_size, filter_size, kernel_size, pad, compute_dtype)
        self.layer_norm_2 = nn.LayerNorm(filter_size, eps=LN_EPS)
        self.linear_layer = nn.Linear(filter_size, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                dropout: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, T, C]; mask: [B, T] True at padding. Returns [B, T]."""
        out = self.layer_norm_1(F.relu(conv1d_cl(self.conv1d_1, x)).float())
        out = _dropout(out, self.dropout, dropout)
        out = self.layer_norm_2(F.relu(conv1d_cl(self.conv1d_2, out)).float())
        out = _dropout(out, self.dropout, dropout)
        out = self.linear_layer(out)[..., 0]
        if mask is not None:
            out = out.masked_fill(mask, 0.0)
        return out


class AugmentationClassifier(nn.Module):
    """GRL -> Linear -> LayerNorm -> ReLU -> Linear(2) -> LogSoftmax, mean
    over the valid positions (reference modules.py:23-45). The gradient
    reversal sits before ``d_fc1``: the classifier's own weights get the
    true gradient, whatever produced ``x`` the reversed one."""

    def __init__(self, in_dim: int, hidden: int = 256, alpha: float = 1.0):
        super().__init__()
        self.alpha = alpha
        self.d_fc1 = nn.Linear(in_dim, hidden)
        self.d_bn1 = nn.LayerNorm(hidden, eps=LN_EPS)
        self.d_fc2 = nn.Linear(hidden, 2)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: [B, T, C] -> log-posterior [B, 2]."""
        h = F.relu(self.d_bn1(self.d_fc1(gradient_reversal(x, self.alpha))))
        score = F.log_softmax(self.d_fc2(h), dim=-1)  # [B, T, 2]
        if mask is None:
            return score.mean(dim=1)
        valid = (~mask)[..., None].to(score.dtype)
        return (score * valid).sum(dim=1) / torch.clamp(valid.sum(dim=1), min=1.0)
