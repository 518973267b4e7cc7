"""Length regulation and mel calibration as closed-form index maps
(counterpart of ``styler_tpu/ops/regulate.py``).

- ``length_regulate``: phoneme -> frame expansion by integer durations,
  a ``searchsorted(right=True)`` over the duration cumsum plus a gather.
- ``mel_calibrate``: frame -> phoneme resampling (the reference's
  ``get_scale`` grouped mean / repeat-interleave) as an exact integer
  group map turned into a per-example [S, M] matrix and applied as one
  f32 batched matmul. The caller keeps TF32 off (``core/device.py``),
  as the reference runs it at ``Precision.HIGHEST``.
"""

from __future__ import annotations

from typing import Tuple

import torch


def length_regulate(
    x: torch.Tensor, durations: torch.Tensor, max_mel_len: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, L, C], durations [B, L] int >= 0 -> (expanded [B, max_mel_len,
    C], mel_len [B]). Frame t copies phoneme l where cumsum(d)[l-1] <= t <
    cumsum(d)[l]; frames >= mel_len are zeros."""
    ends = torch.cumsum(durations.to(torch.int64), dim=1)  # [B, L]
    mel_len = ends[:, -1]
    frames = torch.arange(max_mel_len, device=x.device, dtype=torch.int64)
    idx = torch.searchsorted(ends, frames.expand(x.shape[0], -1).contiguous(), right=True)
    idx = torch.clamp(idx, max=x.shape[1] - 1)
    expanded = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
    valid = frames[None, :] < mel_len[:, None]
    expanded = expanded.masked_fill(~valid[..., None], 0.0)
    return expanded, mel_len.to(torch.int32)


def _group_index(i, q, r):
    """Group id of element ``i`` when ``n = q*k + r`` elements split into
    ``k`` groups of q+1 (the first r) then q — reference get_scale."""
    qp1 = q + 1
    boundary = r * qp1
    q_safe = torch.clamp(q, min=1)
    return torch.where(i < boundary, torch.div(i, qp1, rounding_mode="floor"),
                       r + torch.div(i - boundary, q_safe, rounding_mode="floor"))


def calibration_matrix(
    mel_len: torch.Tensor, seq_len: torch.Tensor, max_mel: int, max_src: int
) -> torch.Tensor:
    """[B] lengths -> [B, max_src, max_mel] f32 matrices A with out = A @ mel.

    mel_len > seq_len: compression, A[s, m] = 1/|group s| for m in group s;
    mel_len < seq_len: expansion, A[s, m] = 1 where m is the source of s;
    equal: identity. Rows s >= seq_len and columns m >= mel_len are zero.
    """
    dev = mel_len.device
    ml = torch.clamp(mel_len.to(torch.int64), min=1)[:, None, None]
    sl = torch.clamp(seq_len.to(torch.int64), min=1)[:, None, None]
    s_ids = torch.arange(max_src, device=dev, dtype=torch.int64)[None, :, None]
    m_ids = torch.arange(max_mel, device=dev, dtype=torch.int64)[None, None, :]

    qc, rc = torch.div(ml, sl, rounding_mode="floor"), ml % sl
    g_m = _group_index(m_ids, qc, rc)
    size_s = qc + (s_ids < rc).to(torch.int64)
    a_comp = (g_m == s_ids).to(torch.float32) / torch.clamp(size_s, min=1).to(torch.float32)

    qe, re_ = torch.div(sl, ml, rounding_mode="floor"), sl % ml
    g_s = _group_index(s_ids, qe, re_)
    a_exp = (g_s == m_ids).to(torch.float32)

    a = torch.where(ml > sl, a_comp, a_exp)
    valid = (s_ids < sl) & (m_ids < ml)
    return a * valid.to(torch.float32)


def mel_calibrate(
    mel: torch.Tensor, mel_len: torch.Tensor, seq_len: torch.Tensor, max_src: int
) -> torch.Tensor:
    """Resample [B, M, C] frame-domain features to [B, max_src, C]."""
    a = calibration_matrix(mel_len, seq_len, mel.shape[1], max_src)
    return torch.bmm(a, mel.float())
