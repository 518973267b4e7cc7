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
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from styler_tpu_torch.ops import build

LRELU_SLOPE = 0.1

# epilogue flags of csrc/resblock.cu
_RES, _ACC_READ, _ACC_WRITE, _FINAL = 1, 2, 4, 8

BranchParams = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


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
    branch_params: Sequence[BranchParams],
    kernel_sizes: Tuple[int, ...] = (3, 7, 11),
    dilations: Tuple[int, ...] = (1, 3, 5),
) -> torch.Tensor:
    """Mean over ResBlock1 branches of the residual conv chains.

    x: [B, T, C] in the compute dtype (float32 or bfloat16).
    branch_params: per kernel size, (w1, b1, w2, b2) with w* [n_dil, k,
    C, C] in the flax layout stacked over dilations and b* [n_dil, C].
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (18 launches for 3 branches x 3 dilations) or raises.
    """
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
