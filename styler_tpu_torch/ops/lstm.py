"""LSTM recurrence over precomputed input gates.

Kernel B of the port. It replaces the forward Pallas TPU kernel
``styler_tpu/ops/pallas_lstm.py:lstm_recurrence_pallas``
(``_run_forward``/``_fwd_kernel``) with the hand-written CUDA kernel
``csrc/lstm.cu``: one CTA per sequence runs all T steps with w_hh
resident in shared memory and h/c on chip. One launch covers several
independent recurrences of different widths, each zero-padded to a
common hidden size Hp (exact: padded units stay 0, as in the Pallas
kernel's own lane padding). Source note, bound and design: see the
header of ``csrc/lstm.cu``.

Layout (all float32):
    gates [S, B, T, 4*Hp]  input gates x @ w_ih.T + b_ih + b_hh, torch
                           gate order (i, f, g, o), gate k of unit u at
                           k*Hp + u
    w_t   [S, Hp, 4*Hp]    w_t[s, j, k*Hp + u] = w_hh_s[k*H + u, j]
    h     [S, B, T, Hp]
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from styler_tpu_torch.ops import build


def pack_gates(gates: Sequence[torch.Tensor], hp: int) -> torch.Tensor:
    """Per recurrence [B, T, 4H_s] -> [S, B, T, 4*hp], zero-padded per gate."""
    out = []
    for g in gates:
        B, T, four_h = g.shape
        H = four_h // 4
        g4 = g.float().reshape(B, T, 4, H)
        out.append(torch.nn.functional.pad(g4, (0, hp - H)).reshape(B, T, 4 * hp))
    return torch.stack(out).contiguous()


def pack_w_hh(w_hh: Sequence[torch.Tensor], hp: int) -> torch.Tensor:
    """Per recurrence torch-layout w_hh [4H_s, H_s] -> w_t [S, hp, 4*hp]."""
    out = []
    for w in w_hh:
        H = w.shape[1]
        w4 = w.float().reshape(4, H, H).permute(2, 0, 1)  # [j, k, u]
        w4 = torch.nn.functional.pad(w4, (0, hp - H, 0, 0, 0, hp - H))
        out.append(w4.reshape(hp, 4 * hp))
    return torch.stack(out).contiguous()


def lstm_recurrence_plain(gates: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the per-step loop, h/c starting at 0."""
    S, B, T, G = gates.shape
    hp = G // 4
    h = gates.new_zeros(S, B, hp)
    c = gates.new_zeros(S, B, hp)
    hs = []
    for t in range(T):
        g = gates[:, :, t] + torch.bmm(h, w_t)
        i, f, gg, o = g.split(hp, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=2)


def _library():
    lib = build.load("lstm")
    if not getattr(lib, "_styler_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.styler_lstm_recurrence.argtypes = [p, p, p, i, i, i, i, p]
        lib.styler_lstm_recurrence.restype = ctypes.c_int
        lib._styler_bound = True
    return lib


def lstm_recurrence(gates: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
    """h [S, B, T, Hp] of S*B independent LSTM recurrences (layout in the
    module docstring). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel once or raises."""
    if gates.device.type == "cpu":
        return lstm_recurrence_plain(gates, w_t)
    if gates.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {gates.device}")
    if gates.dim() != 4 or w_t.dim() != 3:
        raise ValueError("gates must be [S, B, T, 4*Hp] and w_t [S, Hp, 4*Hp]")
    S, B, T, G = gates.shape
    hp = G // 4
    if G != 4 * hp or tuple(w_t.shape) != (S, hp, G) or hp > 256:
        raise ValueError(
            f"shapes gates {tuple(gates.shape)} / w_t {tuple(w_t.shape)} "
            "do not match (Hp <= 256)"
        )
    for name, t in (("gates", gates), ("w_t", w_t)):
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != gates.device:
            raise ValueError(f"{name} must be contiguous float32 on {gates.device}")
    h = torch.empty(S, B, T, hp, device=gates.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(gates.device).cuda_stream
    rc = _library().styler_lstm_recurrence(
        gates.data_ptr(), w_t.data_ptr(), h.data_ptr(), S, B, T, hp, stream
    )
    build.check(rc, "LSTM recurrence kernel")
    lstm_recurrence.launches += 1
    return h


lstm_recurrence.launches = 0
