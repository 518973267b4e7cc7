"""Bidirectional multi-layer LSTMs of the audio encoder
(counterpart of ``styler_tpu/ops/recurrent.py``).

Weights keep the PyTorch layout (w_ih [4H, In], w_hh [4H, H], gate order
i, f, g, o). The input projection of every step is one matmul outside the
recurrence; the recurrence itself runs in kernel B (``ops/lstm.py``),
which takes every branch and both directions of a layer in one launch.

The backward direction flips each sequence within its VALID length and
keeps padding at zero, so ``nn.LSTM`` on packed sequences is not this
function: for a padded batch it lets the backward pass see the padding
differently.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from styler_tpu_torch.ops.lstm import lstm_recurrence, pack_gates, pack_w_hh

LayerParams = Dict[str, Dict[str, torch.Tensor]]


def flip_padded(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each sequence within its valid length; padding -> 0.

    x: [B, T, C]; lengths: [B]. out[b, t] = x[b, len_b-1-t] for t < len_b.
    """
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    src = lengths[:, None].to(torch.int64) - 1 - t
    valid = src >= 0
    src = torch.clamp(src, 0, T - 1)
    out = torch.gather(x, 1, src[..., None].expand(-1, -1, x.shape[2]))
    return out.masked_fill(~valid[..., None], 0.0)


def fused_bilstm_branches(
    branch_params: List[List[LayerParams]],
    xs: List[torch.Tensor],
    lengths: torch.Tensor,
) -> List[torch.Tensor]:
    """Several independent multi-layer BiLSTMs (same T and lengths,
    different widths), one kernel launch per layer for all branches and
    both directions.

    branch_params: per branch, per layer, {"fwd"|"bwd": {w_ih, w_hh, b_ih,
    b_hh}}. xs: per branch [B, T, In_b]. Returns per branch [B, T, 2H_b].
    """
    hiddens = [p[0]["fwd"]["w_hh"].shape[1] for p in branch_params]
    hp = max(hiddens)
    outs = list(xs)
    for layer in range(len(branch_params[0])):
        gates, w_hh = [], []
        for b, params in enumerate(branch_params):
            for d in ("fwd", "bwd"):
                p = params[layer][d]
                x = outs[b] if d == "fwd" else flip_padded(outs[b], lengths)
                gates.append(torch.matmul(x.float(), p["w_ih"].t()) + p["b_ih"] + p["b_hh"])
                w_hh.append(p["w_hh"])
        h = lstm_recurrence(pack_gates(gates, hp), pack_w_hh(w_hh, hp))
        outs = [
            torch.cat(
                [h[2 * b, ..., :H], flip_padded(h[2 * b + 1, ..., :H], lengths)], dim=-1
            )
            for b, H in enumerate(hiddens)
        ]
    return outs
