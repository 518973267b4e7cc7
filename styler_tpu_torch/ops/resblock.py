"""Resblock stage of the HiFi-GAN / iSTFTNet generators (inference).

One upsample stage runs 3 parallel ResBlock1 branches (kernel sizes
3/7/11, dilations 1/3/5): per branch ``x += c2(lrelu(c1(lrelu(x))))`` for
each dilation, then the mean over branches — 18 convolutions.

Kernel A of the port. It replaces the Pallas TPU kernel
``styler_tpu/ops/pallas_resblock.py:fused_resblock_stage`` (exact mode)
with the hand-written CUDA kernel ``csrc/resblock.cu``: one dilated conv
per launch with leaky-ReLU, SAME padding, bias, the f32 residual carry and
the branch mean fused into its load and epilogue; 18 launches per stage.
The TPU kernel's block-Toeplitz channel fold exists only to fill the
TPU's 128 lanes and has no counterpart here. Source note, bound and
design: see the header of ``csrc/resblock.cu``.

Semantics are the TPU kernel's, not the flax ``ResBlock1``'s: matmul
inputs are in the compute dtype with f32 accumulation, the residual carry
stays f32 between convs, and only the stage output is cast to the compute
dtype (flax in bf16 rounds the carry to bf16 after every conv).

int8 form (``quantize=True``; the TPU kernel's quantize mode,
``pallas_resblock.py:145-159,266-281``) -> ``csrc/resblock_int8.cu``, also
18 launches per stage. Every conv is int8 x int8 -> int32:

- weights, once per generator (``quantize_branch_params``): one scale per
  conv and output channel, ``s_w[c] = max(max_{j,cin} |w[j,cin,c]|, 1e-12)
  * (1/127)``, ``q = clip(round(w / s_w), -127, 127)``;
- activations, per conv and per (batch row, output tile of ``INT8_TILE``
  rows): over the tile's input rows plus the conv's halo ((k-1)/2 * d rows
  each side, zeros outside [0, T)), ``s_x = max(max |lrelu(x)|, 1e-6) *
  (1/127)`` and ``q = clip(round(lrelu(x) * (1/s_x)), -127, 127)``, the
  reciprocals in f32 and rounding half to even on both sides;
- epilogue: ``f32(int32 sum) * (s_x * s_w[c]) + bias``, then the exact
  form's residual / branch-sum / final-cast flags; the carry stays f32.

The TPU kernel takes its activation scale over a VMEM tile of 512 to 4096
samples with the halo of the whole chain; the port's tile is its own
kernel's output tile, so the two int8 paths agree to quantisation noise,
not bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from styler_tpu_torch.ops import build

LRELU_SLOPE = 0.1

# epilogue flags of csrc/resblock.cu
_RES, _ACC_READ, _ACC_WRITE, _FINAL = 1, 2, 4, 8

BranchParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

#: output rows per activation-scale tile of the int8 form: the time rows of
#: one CTA of csrc/resblock_int8.cu (its I_BM) and of the plain version
INT8_TILE = 128
_INV127 = 1.0 / 127.0


class Int8Branch(NamedTuple):
    """One branch quantised for the int8 form: w1, w2 int8 [n_dil, k, Cout,
    Cin] (the kernel's layout: input channels contiguous), s1, s2 f32
    [n_dil, Cout] per-output-channel scales, b1, b2 f32 [n_dil, Cout]."""

    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor


def _conv_plain(x32, w, b, dilation, dtype):
    """SAME dilated conv of lrelu(x32): inputs rounded to ``dtype``, f32
    sums over the taps. w: [k, Cin, Cout] (flax layout), b: [Cout]."""
    k = w.shape[0]
    half = (k - 1) // 2
    T = x32.shape[1]
    xin = F.leaky_relu(x32, LRELU_SLOPE).to(dtype).float()
    pad = half * dilation
    xp = F.pad(xin, (0, 0, pad, pad))
    wf = w.to(dtype).float()
    out = xp[:, :T] @ wf[0]
    for j in range(1, k):
        out = out + xp[:, j * dilation : j * dilation + T] @ wf[j]
    return out + b.float()


def resblock_stage_plain(
    x: torch.Tensor,
    branch_params: Sequence[BranchParams],
    kernel_sizes: Tuple[int, ...] = (3, 7, 11),
    dilations: Tuple[int, ...] = (1, 3, 5),
) -> torch.Tensor:
    """Plain PyTorch version of the stage: a loop over taps per conv,
    with the kernel's arithmetic (see module docstring)."""
    dtype = x.dtype
    x32 = x.float()
    total = None
    for (w1, b1, w2, b2) in branch_params:
        xb = x32
        for i, d in enumerate(dilations):
            xt = _conv_plain(xb, w1[i], b1[i], d, dtype)
            xt = _conv_plain(xt, w2[i], b2[i], 1, dtype)
            xb = xb + xt
        total = xb if total is None else total + xb
    return (total * (1.0 / len(branch_params))).to(dtype)


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [n_dil, k, Cin, Cout] (flax layout) -> (q int8 [n_dil, k, Cout, Cin],
    s f32 [n_dil, Cout]): per conv, one scale per output channel over all
    taps and input channels (``pallas_resblock.py:274-279``)."""
    w = w.detach().float()
    s = torch.clamp_min(w.abs().amax(dim=(1, 2)), 1e-12) * _INV127
    q = torch.clamp(torch.round(w / s[:, None, None, :]), -127, 127).to(torch.int8)
    return q.transpose(2, 3).contiguous(), s


def quantize_branch_params(branch_params: Sequence[BranchParams]) -> list:
    """Each branch's (w1, b1, w2, b2) -> ``Int8Branch``, on its device."""
    out = []
    for (w1, b1, w2, b2) in branch_params:
        q1, s1 = quantize_weights(w1)
        q2, s2 = quantize_weights(w2)
        out.append(Int8Branch(q1, s1, b1.detach().float().contiguous(),
                              q2, s2, b2.detach().float().contiguous()))
    return out


def _tile_scales(a: torch.Tensor, halo: int, tile: int) -> torch.Tensor:
    """Activation scale per (batch row, output tile): a [B, T, C] activated
    f32 -> s_x [B, ceil(T / tile)] over each tile's rows plus ``halo``."""
    B, T, _ = a.shape
    n = -(-T // tile)
    rmax = F.pad(a.abs().amax(dim=2), (halo, n * tile - T + halo))  # zeros outside [0, T)
    return torch.clamp_min(rmax.unfold(1, tile + 2 * halo, tile).amax(dim=2), 1e-6) * _INV127


def _conv_int8_plain(x32, q, s_w, b, dilation, tile):
    """SAME dilated int8 conv of lrelu(x32): q int8 [k, Cout, Cin], s_w and
    b f32 [Cout]. Each output tile quantises its own input window (tile
    rows plus the halo) with its own scale; the integer products are summed
    exactly in float64."""
    k = q.shape[0]
    B, T, _ = x32.shape
    pad = (k - 1) // 2 * dilation
    a = F.leaky_relu(x32, LRELU_SLOPE)
    s_x = _tile_scales(a, pad, tile)  # [B, n]
    n = s_x.shape[1]
    win = F.pad(a, (0, 0, pad, n * tile - T + pad)).unfold(1, tile + 2 * pad, tile)
    win = win.permute(0, 1, 3, 2)  # [B, n, tile + 2 pad, Cin]
    qx = torch.clamp(torch.round(win * (1.0 / s_x)[..., None, None]), -127, 127).double()
    wq = q.double()
    acc = qx[:, :, :tile] @ wq[0].t()
    for j in range(1, k):
        acc = acc + qx[:, :, j * dilation : j * dilation + tile] @ wq[j].t()
    acc = acc.float().reshape(B, n * tile, -1)[:, :T]  # int32 sums -> f32, as the kernel
    scale = (s_x[..., None] * s_w).repeat_interleave(tile, dim=1)[:, :T]
    return acc * scale + b


def resblock_stage_int8_plain(
    x: torch.Tensor,
    branches: Sequence[Int8Branch],
    kernel_sizes: Tuple[int, ...] = (3, 7, 11),
    dilations: Tuple[int, ...] = (1, 3, 5),
    tile: int = INT8_TILE,
) -> torch.Tensor:
    """Plain PyTorch version of the int8 stage (module docstring)."""
    dtype = x.dtype
    x32 = x.float()
    total = None
    for br in branches:
        xb = x32
        for i, d in enumerate(dilations):
            xt = _conv_int8_plain(xb, br.w1[i], br.s1[i], br.b1[i], d, tile)
            xt = _conv_int8_plain(xt, br.w2[i], br.s2[i], br.b2[i], 1, tile)
            xb = xb + xt
        total = xb if total is None else total + xb
    return (total * (1.0 / len(branches))).to(dtype)


def _check_cuda_args(x, branch_params, kernel_sizes, dilations):
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, T, C] tensor, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    C = x.shape[2]
    if x.dtype == torch.bfloat16 and C % 8:
        raise ValueError(f"the bf16 kernel needs C % 8 == 0 (16-byte rows), got C={C}")
    if len(branch_params) != len(kernel_sizes):
        raise ValueError("one (w1, b1, w2, b2) per kernel size expected")
    for (w1, b1, w2, b2), k in zip(branch_params, kernel_sizes):
        for w in (w1, w2):
            if tuple(w.shape) != (len(dilations), k, C, C):
                raise ValueError(
                    f"weights must be [n_dil, k, C, C] = "
                    f"{(len(dilations), k, C, C)}, got {tuple(w.shape)}"
                )
            if w.device != x.device:
                raise ValueError("weights and x must be on the same device")
        for b in (b1, b2):
            if tuple(b.shape) != (len(dilations), C) or b.device != x.device:
                raise ValueError(f"biases must be [n_dil, C] on {x.device}")


def _launch(lib, x_in, w, b, res, acc, out32, out_final, k, dil, flags, scale, bf16):
    B, T, C = x_in.shape
    stream = torch.cuda.current_stream(x_in.device).cuda_stream
    rc = lib.styler_resblock_conv(
        x_in.data_ptr(), w.data_ptr(), b.data_ptr(),
        res.data_ptr() if res is not None else None,
        acc.data_ptr(), out32.data_ptr(), out_final.data_ptr(),
        B, T, C, k, dil, flags, scale, bf16, stream,
    )
    build.check(rc, "resblock conv kernel")
    fused_resblock_stage.launches += 1


def _library():
    lib = build.load("resblock")
    if not getattr(lib, "_styler_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.styler_resblock_conv.argtypes = [
            p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p,
        ]
        lib.styler_resblock_conv.restype = ctypes.c_int
        lib._styler_bound = True
    return lib


def fused_resblock_stage(
    x: torch.Tensor,
    branch_params: Sequence[Union[BranchParams, Int8Branch]],
    kernel_sizes: Tuple[int, ...] = (3, 7, 11),
    dilations: Tuple[int, ...] = (1, 3, 5),
    quantize: bool = False,
) -> torch.Tensor:
    """Mean over ResBlock1 branches of the residual conv chains.

    x: [B, T, C] in the compute dtype (float32 or bfloat16).
    branch_params: per kernel size, (w1, b1, w2, b2) with w* [n_dil, k,
    C, C] in the flax layout stacked over dilations and b* [n_dil, C].
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (18 launches for 3 branches x 3 dilations) or raises.
    ``quantize=True`` runs the int8 form (``resblock_stage_int8``) on
    ``Int8Branch`` params, quantising float params here if given those.
    """
    if quantize:
        if not all(isinstance(bp, Int8Branch) for bp in branch_params):
            branch_params = quantize_branch_params(branch_params)
        return resblock_stage_int8(x, branch_params, kernel_sizes, dilations)
    if x.device.type == "cpu":
        return resblock_stage_plain(x, branch_params, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"no resblock kernel for device {x.device}")
    _check_cuda_args(x, branch_params, kernel_sizes, dilations)
    lib = _library()
    dtype = x.dtype
    bf16 = 1 if dtype == torch.bfloat16 else 0
    x32 = x.float()
    y = torch.empty_like(x32)
    carry = torch.empty_like(x32)
    acc = torch.empty_like(x32)
    out = torch.empty_like(x)
    n_br = len(branch_params)
    scale = 1.0 / n_br
    for br, ((w1, b1, w2, b2), k) in enumerate(zip(branch_params, kernel_sizes)):
        w1c = w1.to(dtype).contiguous()
        w2c = w2.to(dtype).contiguous()
        b1c = b1.float().contiguous()
        b2c = b2.float().contiguous()
        src = x32
        for i, d in enumerate(dilations):
            _launch(lib, src, w1c[i], b1c[i], None, acc, y, out, k, d, 0, scale, bf16)
            flags = _RES
            if i == len(dilations) - 1:
                if br > 0:
                    flags |= _ACC_READ
                flags |= _FINAL if br == n_br - 1 else _ACC_WRITE
            _launch(lib, y, w2c[i], b2c[i], src, acc, carry, out, k, 1, flags, scale, bf16)
            src = carry
    return out


fused_resblock_stage.launches = 0


def _check_int8_args(x, branches, kernel_sizes, dilations):
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, T, C] tensor, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    C = x.shape[2]
    if C % 16:
        raise ValueError(f"the int8 kernel needs C % 16 == 0 (16-byte weight rows), got C={C}")
    if len(branches) != len(kernel_sizes):
        raise ValueError("one Int8Branch per kernel size expected")
    for br, k in zip(branches, kernel_sizes):
        if not isinstance(br, Int8Branch):
            raise TypeError("the int8 kernel takes Int8Branch params (quantize_branch_params)")
        for w in (br.w1, br.w2):
            if w.dtype != torch.int8 or tuple(w.shape) != (len(dilations), k, C, C):
                raise ValueError(f"int8 weights must be int8 [n_dil, k, C, C] = "
                                 f"{(len(dilations), k, C, C)}, got {w.dtype} {tuple(w.shape)}")
        for t in (br.w1, br.s1, br.b1, br.w2, br.s2, br.b2):
            if t.device != x.device or not t.is_contiguous():
                raise ValueError(f"int8 params must be contiguous on {x.device}")
        for t in (br.s1, br.b1, br.s2, br.b2):
            if t.dtype != torch.float32 or tuple(t.shape) != (len(dilations), C):
                raise ValueError(f"scales and biases must be float32 [n_dil, C], got "
                                 f"{t.dtype} {tuple(t.shape)}")


def _int8_library():
    lib = build.load("resblock_int8")
    if not getattr(lib, "_styler_bound", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.styler_resblock_conv_int8.argtypes = [
            p, p, p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p,
        ]
        lib.styler_resblock_conv_int8.restype = ctypes.c_int
        lib._styler_bound = True
    return lib


def resblock_stage_int8(
    x: torch.Tensor,
    branches: Sequence[Int8Branch],
    kernel_sizes: Tuple[int, ...] = (3, 7, 11),
    dilations: Tuple[int, ...] = (1, 3, 5),
) -> torch.Tensor:
    """The int8 form of the stage on ``Int8Branch`` params (module
    docstring). A CPU tensor takes ``resblock_stage_int8_plain``; a CUDA
    tensor launches ``csrc/resblock_int8.cu`` 18 times or raises."""
    if x.device.type == "cpu":
        return resblock_stage_int8_plain(x, branches, kernel_sizes, dilations)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 resblock kernel for device {x.device}")
    _check_int8_args(x, branches, kernel_sizes, dilations)
    lib = _int8_library()
    B, T, C = x.shape
    bf16_out = 1 if x.dtype == torch.bfloat16 else 0
    x32 = x.float()
    y = torch.empty_like(x32)
    carry = torch.empty_like(x32)
    acc = torch.empty_like(x32)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    n_br = len(branches)
    scale = 1.0 / n_br

    def launch(src, w, s, b, res, dst32, k, dil, flags):
        rc = lib.styler_resblock_conv_int8(
            src.data_ptr(), w.data_ptr(), s.data_ptr(), b.data_ptr(),
            res.data_ptr() if res is not None else None, acc.data_ptr(), dst32.data_ptr(),
            out.data_ptr(), B, T, C, k, dil, flags, scale, bf16_out, stream,
        )
        build.check(rc, "int8 resblock conv kernel")
        resblock_stage_int8.launches += 1

    for br_i, (br, k) in enumerate(zip(branches, kernel_sizes)):
        src = x32
        for i, d in enumerate(dilations):
            launch(src, br.w1[i], br.s1[i], br.b1[i], None, y, k, d, 0)
            flags = _RES
            if i == len(dilations) - 1:
                if br_i > 0:
                    flags |= _ACC_READ
                flags |= _FINAL if br_i == n_br - 1 else _ACC_WRITE
            launch(y, br.w2[i], br.s2[i], br.b2[i], src, carry, k, 1, flags)
            src = carry
    return out


resblock_stage_int8.launches = 0
