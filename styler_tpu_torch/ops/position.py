"""Sinusoid positional encoding table (reference transformer/Models.py:11-30)."""

from __future__ import annotations

import numpy as np


def sinusoid_table(n_position: int, d_hid: int, padding_idx=None) -> np.ndarray:
    """angle(pos, j) = pos / 10000^(2*(j//2)/d); sin on even dims, cos on odd."""
    pos = np.arange(n_position)[:, None].astype(np.float64)
    j = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000.0, 2 * (j // 2) / d_hid)
    table = np.zeros((n_position, d_hid), dtype=np.float64)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    if padding_idx is not None:
        table[padding_idx] = 0.0
    return table.astype(np.float32)
