"""Mask construction (reference utils.py:223-232 semantics).

Masks are True at PADDING positions, matching the reference convention.
The reference's ``masked_fill`` is torch's own ``Tensor.masked_fill``.
"""

from __future__ import annotations

import torch


def mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths -> [B, max_len] bool mask, True where t >= length."""
    ids = torch.arange(max_len, device=lengths.device)[None, :]
    return ids >= lengths[:, None]

