"""LSTM recurrence over precomputed input gates, forward and backward.

Kernels B and C of the port. Kernel B replaces the forward Pallas TPU
kernel ``styler_tpu/ops/pallas_lstm.py:lstm_recurrence_pallas``
(``_run_forward``/``_fwd_kernel``) with the hand-written CUDA kernel
``csrc/lstm.cu``: one CTA per sequence runs all T steps with w_hh on
chip (in registers up to Hp = 96) and h/c on chip, one barrier a step.
Kernel C replaces its BPTT backward (``_run_backward``/``_bwd_kernel``)
with ``csrc/lstm_bwd.cu``: a reverse walk of the same shape that emits
d(gates) and carries dh/dc on chip, followed by a tiled product that
forms dW_hh over time and batch rows, split into groups of rows and
summed in a fixed order. ``LSTMRecurrence`` pairs the two as one
differentiable function, as the reference's ``custom_vjp`` does.

One launch covers several independent recurrences of different widths,
each zero-padded to a common hidden size Hp (exact: padded units stay 0
in h, c, d(gates) and dW, as in the Pallas kernel's own lane padding).
``lstm_plan`` chooses each launch's instance, threads and dW split from
Hp (and S, B) alone; the sources size its shared memory, and
``lstm_launch_plan`` adds what the built kernels report. Source notes,
bounds and designs: see the headers of the two sources.

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


#: the kernels' plan instances, in the index order the sources use
INSTANCES = ("registers", "shared", "global")
MAX_HP = 256
#: the widest W (Hp rounded up to 8) of each instance class. The register
#: instances hold W weights a thread up to 96; the shared instance's padded
#: weight copy fits one block's shared memory up to 120 for the recurrence
#: and 112 for the walk, whose d(gates) buffer is larger; where it fits, it
#: beats reading w_t (on an H100 at Hp = 104 and 112, 1.5-1.9x for the
#: recurrence and 4-6x for the walk: ``tools/lstm_steps.py``'s width
#: sweep). The sources size each launch's shared memory and refuse one
#: that does not fit.
REGISTER_WIDTH_MAX = 96
SHARED_WIDTH_MAX = {"recurrence": 120, "backward": 112}
DW_TR = 64  # dW tile columns (DW_TR in lstm_bwd.cu)
#: CTAs the dW product's batch-row split aims at: five per SM of a 132-SM
#: H100. Fixed, so the split, and with it dW's order of summation, is the
#: same on every card.
DW_TARGET_CTAS = 660

_forced = {"instance": None}


def _width(hp: int) -> int:
    return -(-hp // 8) * 8


def lstm_plan(hp: int, S: int = 1, B: int = 1, dw_splits: int = None) -> dict:
    """The launch plan of kernels B and C at width ``hp`` for S*B
    sequences, chosen from ``hp`` alone, the same way on every card:

    - ``recurrence`` and ``backward`` (the walk): instance ``registers``
      while W = hp rounded up to 8 is at most REGISTER_WIDTH_MAX (each
      thread keeps its W weights in registers), else ``shared`` up to
      SHARED_WIDTH_MAX (the weights copied into shared memory), else
      ``global`` (read from w_t); threads 4*W, S*B CTAs;
    - the dW product: a [TJ, 64] tile (TJ = hp rounded up to 16, or the
      half of it above 128), the grid, and the batch rows split into
      ``dw_splits`` groups of ``dw_rows_per_split`` so about
      DW_TARGET_CTAS CTAs run.

    ``dw_splits`` overrides the split (timing only, through
    ``lstm_backward_part``) and ``force_lstm_plan`` the instance (sweeps
    only); a forced instance that does not take ``hp`` raises ValueError.
    ``lstm_launch_plan`` adds the shared memory and registers the built
    kernels report for the plan."""
    if not 1 <= hp <= MAX_HP:
        raise ValueError(f"Hp = {hp}: the LSTM kernels take 1 <= Hp <= {MAX_HP}")
    w = _width(hp)
    out = {"hp": hp, "width": w}
    for kernel in ("recurrence", "backward"):
        inst = _forced["instance"] or (
            "registers" if w <= REGISTER_WIDTH_MAX else
            "shared" if w <= SHARED_WIDTH_MAX[kernel] else "global")
        if inst == "registers" and w > REGISTER_WIDTH_MAX:
            raise ValueError(f"Hp = {hp}: no register instance above width {REGISTER_WIDTH_MAX}")
        if inst == "shared" and w > SHARED_WIDTH_MAX[kernel]:
            raise ValueError(f"Hp = {hp}: the {kernel} weights do not fit shared memory")
        out[kernel] = {"instance": inst, "threads": 4 * w, "ctas": S * B}
    n_jt = -(-hp // 128)
    tj = -(-(-(-hp // n_jt)) // 16) * 16
    n_rt = -(-4 * hp // DW_TR)
    B = max(B, 1)
    if dw_splits is not None and dw_splits < 1:
        raise ValueError("dw_splits must be >= 1")
    splits = dw_splits or -(-DW_TARGET_CTAS // (n_rt * n_jt * S))
    rows = -(-B // min(splits, B))
    splits = -(-B // rows)
    out["backward"].update(
        dw_tile=[tj, DW_TR], dw_splits=splits, dw_rows_per_split=rows,
        dw_grid=[n_rt, n_jt, S * splits], dw_threads=4 * tj,
    )
    return out


def force_lstm_plan(instance: str = None) -> None:
    """Sweeps only: run every launch on ``instance`` (one of INSTANCES);
    no argument restores the plan's own choice."""
    if instance is not None and instance not in INSTANCES:
        raise ValueError(f"instance must be one of {INSTANCES}")
    _forced["instance"] = instance


def _library():
    lib = build.load("lstm")
    if not getattr(lib, "_styler_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.styler_lstm_recurrence.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.styler_lstm_recurrence.restype = ctypes.c_int
        lib.styler_lstm_recurrence_train.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
        lib.styler_lstm_recurrence_train.restype = ctypes.c_int
        lib.styler_lstm_plan.argtypes = [i, i, i, p]
        lib.styler_lstm_plan.restype = ctypes.c_int
        lib.styler_lstm_step_probe.argtypes = [p, i, i, i, p]
        lib.styler_lstm_step_probe.restype = ctypes.c_int
        lib._styler_bound = True
    return lib


def _library_bwd():
    lib = build.load("lstm_bwd")
    if not getattr(lib, "_styler_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.styler_lstm_backward.argtypes = [p] * 8 + [i] * 8 + [p]
        lib.styler_lstm_backward.restype = ctypes.c_int
        lib.styler_lstm_bwd_plan.argtypes = [i, i, i, p]
        lib.styler_lstm_bwd_plan.restype = ctypes.c_int
        lib._styler_bound = True
    return lib


def lstm_launch_plan(hp: int, S: int = 1, B: int = 1) -> dict:
    """``lstm_plan`` with what the built kernels report for it on this
    card: the shared memory bytes (static and dynamic, sized by the
    sources) and registers per thread of each form, of the walk and of
    the dW product. Raises if the kernels' threads differ from the
    plan's."""
    plan = lstm_plan(hp, S, B)
    rec, bwd = plan["recurrence"], plan["backward"]
    for save, form in ((0, "serving"), (1, "training")):
        out = (ctypes.c_int * 3)()
        build.check(_library().styler_lstm_plan(INSTANCES.index(rec["instance"]), hp, save, out),
                    "LSTM launch plan")
        if out[0] != rec["threads"]:
            raise RuntimeError(f"lstm.cu plans {list(out)}, ops/lstm.py {rec}")
        rec["smem_bytes"], rec[f"registers_{form}"] = out[1], out[2]
    out = (ctypes.c_int * 6)()
    build.check(_library_bwd().styler_lstm_bwd_plan(INSTANCES.index(bwd["instance"]), hp,
                                                    bwd["dw_tile"][0], out), "LSTM backward plan")
    if [out[0], out[3]] != [bwd["threads"], bwd["dw_threads"]]:
        raise RuntimeError(f"lstm_bwd.cu plans {list(out)}, ops/lstm.py {bwd}")
    bwd.update(smem_bytes=out[1], registers=out[2], dw_smem_bytes=out[4], dw_registers=out[5])
    return plan


def lstm_step_probe(T: int, threads: int, device, ctas: int = 8) -> torch.Tensor:
    """Measurement only: ``ctas`` CTAs of ``threads`` threads run T empty
    steps (one float4 broadcast from shared memory, one store, one
    barrier each), the per-step latency floor of a one-CTA recurrence."""
    out = torch.empty(ctas, device=device)
    build.check(_library().styler_lstm_step_probe(
        out.data_ptr(), ctas, T, threads, torch.cuda.current_stream(out.device).cuda_stream
    ), "LSTM step probe")
    return out


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
    version; a CUDA tensor launches the kernel once, on the instance
    ``lstm_plan`` chooses, or raises."""
    if gates.device.type == "cpu":
        return lstm_recurrence_plain(gates, w_t, save)
    if gates.dim() != 4 or w_t.dim() != 3:
        raise ValueError("gates must be [S, B, T, 4*Hp] and w_t [S, Hp, 4*Hp]")
    S, B, T, G = gates.shape
    hp = G // 4
    if G != 4 * hp or not 1 <= hp <= MAX_HP:
        raise ValueError(f"gates {tuple(gates.shape)}: last axis must be 4*Hp, Hp <= {MAX_HP}")
    dev = _check_cuda({"gates": (gates, gates.shape), "w_t": (w_t, (S, hp, G))})
    instance = INSTANCES.index(lstm_plan(hp, S, B)["recurrence"]["instance"])
    h = torch.empty(S, B, T, hp, device=dev, dtype=torch.float32)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if save:
        c = torch.empty_like(h)
        acts = torch.empty_like(gates)
        rc = _library().styler_lstm_recurrence_train(
            gates.data_ptr(), w_t.data_ptr(), h.data_ptr(), c.data_ptr(), acts.data_ptr(),
            S, B, T, hp, instance, stream,
        )
    else:
        rc = _library().styler_lstm_recurrence(
            gates.data_ptr(), w_t.data_ptr(), h.data_ptr(), S, B, T, hp, instance, stream
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


def lstm_backward(
    dh_out: torch.Tensor, acts: torch.Tensor, c: torch.Tensor, h: torch.Tensor,
    w_t: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """BPTT through the recurrence: (dgates [S, B, T, 4*Hp], dw_t [S, Hp,
    4*Hp]) from the gradient of h and what the training form of
    ``lstm_recurrence`` saved. A CPU tensor takes the plain version; a CUDA
    tensor launches kernel C once (the walk, the dW product and, when the
    plan splits the batch rows, the fixed-order sum of the partials) or
    raises."""
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
    dgates = torch.empty(S, B, T, G, device=dev, dtype=torch.float32)
    dw_t = torch.empty(S, hp, G, device=dev, dtype=torch.float32)
    _launch_backward(3, dh_out, acts, c, h, w_t, dgates, dw_t)
    lstm_backward.launches += 1
    return dgates, dw_t


def _launch_backward(parts, dh_out, acts, c, h, w_t, dgates, dw_t, dw_splits=None) -> None:
    """Kernel C's walk (``parts & 1``: writes dgates) and dW product
    (``parts & 2``: reads dgates, writes dw_t) on checked CUDA tensors,
    the batch rows of dW split as the plan says or in ``dw_splits``."""
    S, B, T, hp = dh_out.shape
    plan = lstm_plan(hp, S, B, dw_splits)["backward"]
    splits = plan["dw_splits"]
    partials = (torch.empty(S, splits, hp, 4 * hp, device=dh_out.device, dtype=torch.float32)
                if splits > 1 and parts & 2 else None)
    rc = _library_bwd().styler_lstm_backward(
        dh_out.data_ptr(), acts.data_ptr(), c.data_ptr(), h.data_ptr(), w_t.data_ptr(),
        dgates.data_ptr(), dw_t.data_ptr(), None if partials is None else partials.data_ptr(),
        S, B, T, hp, INSTANCES.index(plan["instance"]), plan["dw_tile"][0], splits, parts,
        torch.cuda.current_stream(dh_out.device).cuda_stream,
    )
    build.check(rc, "LSTM backward kernel")


def lstm_backward_part(part: str, dh_out, acts, c, h, w_t, dgates, dw_t,
                       dw_splits: int = None) -> None:
    """Measurement only, not counted as a launch of kernel C: run its
    ``"walk"`` alone (writes ``dgates``) or its ``"dw"`` product alone
    (reads ``dgates``, writes ``dw_t``), on the tensors of an earlier
    ``lstm_backward`` call, so the two can be timed apart; ``dw_splits``
    sets the dW product's batch-row split in place of the plan's."""
    _launch_backward({"walk": 1, "dw": 2}[part], dh_out, acts, c, h, w_t, dgates, dw_t,
                     dw_splits)


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
