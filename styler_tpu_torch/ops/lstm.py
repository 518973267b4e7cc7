"""LSTM recurrence over precomputed input gates, forward and backward.

Kernels B and C of the port. Kernel B replaces the forward Pallas TPU
kernel ``styler_tpu/ops/pallas_lstm.py:lstm_recurrence_pallas``
(``_run_forward``/``_fwd_kernel``) with the hand-written CUDA kernel
``csrc/lstm.cu``: one CTA per sequence runs all T steps with w_hh
resident in shared memory and h/c on chip. Kernel C replaces its BPTT
backward (``_run_backward``/``_bwd_kernel``) with ``csrc/lstm_bwd.cu``:
a reverse walk of the same shape that emits d(gates) and carries dh/dc
on chip, followed by a tiled product that forms dW_hh over time and
batch. ``LSTMRecurrence`` pairs the two as one differentiable function,
as the reference's ``custom_vjp`` does.

One launch covers several independent recurrences of different widths,
each zero-padded to a common hidden size Hp (exact: padded units stay 0
in h, c, d(gates) and dW, as in the Pallas kernel's own lane padding).
Source notes, bounds and designs: see the headers of the two sources.

Layout (all float32, contiguous):
    gates [S, B, T, 4*Hp]  input gates x @ w_ih.T + b_ih + b_hh, torch
                           gate order (i, f, g, o), gate k of unit u at
                           k*Hp + u
    w_t   [S, Hp, 4*Hp]    w_t[s, j, k*Hp + u] = w_hh_s[k*H + u, j]
    h, c  [S, B, T, Hp]
    acts  [S, B, T, 4*Hp]  the activated gates (i, f, g, o) of each step

Every function takes its plain PyTorch version for CPU tensors; on a
CUDA tensor it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

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


def lstm_recurrence_plain(gates: torch.Tensor, w_t: torch.Tensor, save: bool = False):
    """Plain PyTorch version of kernel B: the per-step loop, h/c starting
    at 0. ``save=True`` is the training form: (h, c, acts)."""
    S, B, T, G = gates.shape
    hp = G // 4
    h = gates.new_zeros(S, B, hp)
    c = gates.new_zeros(S, B, hp)
    hs, cs, acts = [], [], []
    for t in range(T):
        g = gates[:, :, t] + torch.bmm(h, w_t)
        i, f, gg, o = g.split(hp, dim=-1)
        i, f, gg, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)
        c = f * c + i * gg
        h = o * torch.tanh(c)
        hs.append(h)
        if save:
            cs.append(c)
            acts.append(torch.cat([i, f, gg, o], dim=-1))
    if save:
        return torch.stack(hs, dim=2), torch.stack(cs, dim=2), torch.stack(acts, dim=2)
    return torch.stack(hs, dim=2)


def lstm_backward_plain(
    dh_out: torch.Tensor, acts: torch.Tensor, c: torch.Tensor, h: torch.Tensor,
    w_t: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel C: the reverse loop over t, step by
    step. Returns (dgates [S, B, T, 4*Hp], dw_t [S, Hp, 4*Hp])."""
    S, B, T, hp = dh_out.shape
    dh_carry = dh_out.new_zeros(S, B, hp)
    dc_carry = dh_out.new_zeros(S, B, hp)
    dw = torch.zeros_like(w_t)
    zero = dh_out.new_zeros(S, B, hp)
    w_tt = w_t.transpose(1, 2)
    dgates = [None] * T
    for t in range(T - 1, -1, -1):
        i, f, g, o = acts[:, :, t].split(hp, dim=-1)
        c_prev = c[:, :, t - 1] if t > 0 else zero
        h_prev = h[:, :, t - 1] if t > 0 else zero
        tanh_c = torch.tanh(c[:, :, t])
        dh = dh_out[:, :, t] + dh_carry
        dc = dh * o * (1.0 - tanh_c * tanh_c) + dc_carry
        dg = torch.cat(
            [
                dc * g * i * (1.0 - i),
                dc * c_prev * f * (1.0 - f),
                dc * i * (1.0 - g * g),
                dh * tanh_c * o * (1.0 - o),
            ],
            dim=-1,
        )
        dgates[t] = dg
        dh_carry = torch.bmm(dg, w_tt)
        dc_carry = dc * f
        dw = dw + torch.bmm(h_prev.transpose(1, 2), dg)
    return torch.stack(dgates, dim=2), dw


def _library():
    lib = build.load("lstm")
    if not getattr(lib, "_styler_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.styler_lstm_recurrence.argtypes = [p, p, p, i, i, i, i, p]
        lib.styler_lstm_recurrence.restype = ctypes.c_int
        lib.styler_lstm_recurrence_train.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.styler_lstm_recurrence_train.restype = ctypes.c_int
        lib._styler_bound = True
    return lib


def _library_bwd():
    lib = build.load("lstm_bwd")
    if not getattr(lib, "_styler_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.styler_lstm_backward.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        lib.styler_lstm_backward.restype = ctypes.c_int
        lib.styler_lstm_bwd_smem_bytes.argtypes = [i]
        lib.styler_lstm_bwd_smem_bytes.restype = ctypes.c_int
        lib._styler_bound = True
    return lib


def _check_cuda(tensors: Dict[str, Tuple[torch.Tensor, tuple]]) -> torch.device:
    """Every tensor contiguous float32 of its expected shape on one CUDA
    device; raises otherwise."""
    first = next(iter(tensors.values()))[0]
    if first.device.type != "cuda":
        raise ValueError(f"no LSTM kernel for device {first.device}")
    for name, (t, shape) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.dtype != torch.float32 or not t.is_contiguous() or t.device != first.device:
            raise ValueError(f"{name} must be contiguous float32 on {first.device}")
    return first.device


def lstm_recurrence(gates: torch.Tensor, w_t: torch.Tensor, save: bool = False):
    """h [S, B, T, Hp] of S*B independent LSTM recurrences (layout in the
    module docstring); with ``save=True`` (the training form) also c and
    the activated gates: (h, c, acts). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel once or raises."""
    if gates.device.type == "cpu":
        return lstm_recurrence_plain(gates, w_t, save)
    if gates.dim() != 4 or w_t.dim() != 3:
        raise ValueError("gates must be [S, B, T, 4*Hp] and w_t [S, Hp, 4*Hp]")
    S, B, T, G = gates.shape
    hp = G // 4
    if G != 4 * hp or hp > 256:
        raise ValueError(f"gates {tuple(gates.shape)}: last axis must be 4*Hp, Hp <= 256")
    dev = _check_cuda({"gates": (gates, gates.shape), "w_t": (w_t, (S, hp, G))})
    h = torch.empty(S, B, T, hp, device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if save:
        c = torch.empty_like(h)
        acts = torch.empty_like(gates)
        rc = _library().styler_lstm_recurrence_train(
            gates.data_ptr(), w_t.data_ptr(), h.data_ptr(), c.data_ptr(), acts.data_ptr(),
            S, B, T, hp, stream,
        )
    else:
        rc = _library().styler_lstm_recurrence(
            gates.data_ptr(), w_t.data_ptr(), h.data_ptr(), S, B, T, hp, stream
        )
    build.check(rc, "LSTM recurrence kernel")
    lstm_recurrence.launches += 1
    if save:
        lstm_recurrence.training_launches += 1
        return h, c, acts
    return h


#: launches of kernel B, both forms; and of its training form alone
lstm_recurrence.launches = 0
lstm_recurrence.training_launches = 0

_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90


def lstm_backward(
    dh_out: torch.Tensor, acts: torch.Tensor, c: torch.Tensor, h: torch.Tensor,
    w_t: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BPTT through the recurrence: (dgates [S, B, T, 4*Hp], dw_t [S, Hp,
    4*Hp]) from the gradient of h and what the training form of
    ``lstm_recurrence`` saved. A CPU tensor takes the plain version; a CUDA
    tensor launches kernel C once or raises."""
    if dh_out.device.type == "cpu":
        return lstm_backward_plain(dh_out, acts, c, h, w_t)
    if dh_out.dim() != 4:
        raise ValueError("dh_out must be [S, B, T, Hp]")
    S, B, T, hp = dh_out.shape
    G = 4 * hp
    dev = _check_cuda({
        "dh_out": (dh_out, (S, B, T, hp)), "acts": (acts, (S, B, T, G)),
        "c": (c, (S, B, T, hp)), "h": (h, (S, B, T, hp)), "w_t": (w_t, (S, hp, G)),
    })
    lib = _library_bwd()
    if hp > 256 or lib.styler_lstm_bwd_smem_bytes(hp) > _SMEM_LIMIT:
        raise ValueError(f"Hp = {hp}: w_hh does not fit one block's shared memory")
    dgates = torch.empty(S, B, T, G, device=dev, dtype=torch.float32)
    dw_t = torch.empty(S, hp, G, device=dev, dtype=torch.float32)
    rc = lib.styler_lstm_backward(
        dh_out.data_ptr(), acts.data_ptr(), c.data_ptr(), h.data_ptr(), w_t.data_ptr(),
        dgates.data_ptr(), dw_t.data_ptr(), S, B, T, hp,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(rc, "LSTM backward kernel")
    lstm_backward.launches += 1
    return dgates, dw_t


lstm_backward.launches = 0


class LSTMRecurrence(torch.autograd.Function):
    """``LSTMRecurrence.apply(gates, w_t) -> h``, differentiable in both:
    kernel B forward (its training form when a gradient is wanted),
    kernel C backward."""

    @staticmethod
    def forward(ctx, gates: torch.Tensor, w_t: torch.Tensor) -> torch.Tensor:
        if not any(ctx.needs_input_grad):
            return lstm_recurrence(gates, w_t)
        h, c, acts = lstm_recurrence(gates, w_t, save=True)
        ctx.save_for_backward(h, c, acts, w_t)
        return h

    @staticmethod
    def backward(ctx, dh: torch.Tensor):
        h, c, acts, w_t = ctx.saved_tensors
        return lstm_backward(dh.contiguous(), acts, c, h, w_t)
