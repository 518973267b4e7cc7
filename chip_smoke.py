#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``styler_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name and power limit; fails without a CUDA device.
2. build   — builds every kernel from ``styler_tpu_torch/csrc`` (one nvcc
             per source, in parallel) and prints the ptxas register /
             shared-memory / spill summary.
3. kernels — each kernel against its plain PyTorch version at the shapes
             the main paths give it, with the tolerance stated, and CUDA-event
             times of the kernel, the plain version, a PyTorch library call
             computing the same function (a yardstick the port never calls)
             and the card's lower bound for the same work: kernel A (resblock
             stage), kernel B (LSTM recurrence) in its serving form at the
             serving shapes and in its training form at the training shapes,
             kernel C (LSTM BPTT backward) at the training shapes.
             (Kernel A on the iSTFTNet stages here; on HiFi-GAN's in 6.)
4. main    — ``load_synthesizer(default_config())`` on CUDA, reference
             features of ``assets/vocoder/val/val_0000.wav``, a seeded
             unit-norm speaker embedding, and ``synthesize`` on 3 sentences;
             checks shapes, finiteness and that kernels A and B were launched.
   A profiled request follows (device time by kernel, idle share).
5. card_vs_cpu — one request again with ``device="cpu"`` (plain versions);
             durations and mels at f32 tolerance, waveforms by log-mel
             distance (bf16), the f32 vocoder by SNR.
6. hifigan_kernels — ``load_synthesizer(cfg, vocoder_arch="HiFi-GAN")``;
             kernel A (bf16 and f32) and the int8 kernel against their plain
             versions on the four HiFi-GAN stage inputs of the 2B batch of
             1024-frame mels ([2, 8192, 256] .. [2, 262144, 32]), with times,
             the cuDNN bf16 conv chain as yardstick and the bound.
7. main_hifigan — 3 requests after a warm-up through HiFi-GAN; kernel A
             launches 72 times per request, the int8 kernel never; then a
             profiled request (profile_hifigan).
8. int8    — the same requests with ``STYLER_TPU_INT8_VOCODER=1`` set before
             construction: the int8 kernel 72 times per request, kernel A
             never; a profiled request (profile_int8); log-mel MAE of the
             int8 waveforms against the bf16 ones (fails only above 1.0 or on
             a non-finite result).
9. hifigan_card_vs_cpu — one HiFi-GAN request against ``device="cpu"``.
10. train  — writes a 64-utterance example dataset made from a seed to disk
             and runs ``Trainer(...).fit`` on CUDA from the committed trained
             weights at full width, batch 16, dropout on: one warm-up step and
             three timed ones. Checks the 10 loss components, the gradient
             norm, that every parameter had a gradient and nearly all changed,
             that the BatchNorm statistics moved, and that kernel B's training
             form and kernel C were each launched 4 times per step.
11. train_profile — one more step under ``torch.profiler``.
12. train_card_vs_cpu — one step's loss components and every gradient leaf,
             without dropout, on the card against ``device="cpu"``.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line is printed. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12  # dense int8 tensor-core operations per second
PEAK_F32 = 67e12  # f32 outside the tensor cores (no TF32)
HBM_BYTES_PER_S = 3.35e12
# int8 kernel vs its plain version, bf16 output: 2 bf16 ulps of the scale
INT8_TOL = 2 ** -7

SENTENCES = (
    "Hello there.",
    "The quick brown fox jumps over the lazy dog.",
    "Printing, in the only sense with which we are at present concerned, "
    "differs from most if not from all the arts and crafts represented in "
    "the exhibition.",
)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of fn() over iters runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, peak: float, n_bytes: float):
    t_ops, t_bytes = flops / peak * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ptxas_summary(report: dict) -> dict:
    out = {}
    for name, log in report.items():
        entries = []
        for m in re.finditer(
            r"Compiling entry function '(\S+)'.*?(\d+) bytes spill stores, (\d+) bytes "
            r"spill loads.*?Used (\d+) registers(?:.*?(\d+) bytes smem)?",
            log, re.S,
        ):
            entries.append({
                "function": m.group(1), "registers": int(m.group(4)),
                "static_smem_bytes": int(m.group(5) or 0),
                "spill_store_bytes": int(m.group(2)), "spill_load_bytes": int(m.group(3)),
            })
        out[name] = entries
    return out


def resblock_library(torch, F, x, bp, kernel_sizes, dilations):
    """Yardstick: the unfused stage as a chain of cuDNN F.conv1d calls in
    the compute dtype (channels-first), as the flax ResBlock1 composes it."""
    xc = x.transpose(1, 2)
    total = None
    for (w1, b1, w2, b2), k in zip(bp, kernel_sizes):
        xb = xc
        for i, d in enumerate(dilations):
            xt = F.conv1d(F.leaky_relu(xb, 0.1), w1[i], b1[i], padding=d * (k - 1) // 2, dilation=d)
            xt = F.conv1d(F.leaky_relu(xt, 0.1), w2[i], b2[i], padding=(k - 1) // 2)
            xb = xb + xt
        total = xb if total is None else total + xb
    return (total / len(bp)).transpose(1, 2)


def stage_inputs(torch, g, mel2b):
    """The input of every resblock stage of generator ``g`` for the 2B mel
    batch, as the main path produces it (kernel A runs the stages)."""
    import torch.nn.functional as F

    from styler_tpu_torch.ops.resblock import fused_resblock_stage

    ks = tuple(g.config.resblock_kernel_sizes)
    dils = tuple(g.config.resblock_dilation_sizes[0])
    out = []
    with torch.no_grad():
        x = g._conv(g.conv_pre, mel2b)
        for i in range(len(g.config.upsample_rates)):
            x = getattr(g, f"ups_{i}")(F.leaky_relu(x, 0.1)).contiguous()
            out.append(x)
            blocks = [getattr(g, f"resblocks_{i}_{j}") for j in range(len(ks))]
            x = fused_resblock_stage(x, [b.branch_params() for b in blocks], ks, dils)
    return out, ks, dils


def phase_resblock(torch, g, mel2b, path, int8=False):
    """Kernel A (bf16 and f32) against its plain version on every stage of
    generator ``g`` at the main path's shapes and data (the stage inputs of
    a 2B batch of 1024-frame mels); with ``int8`` also the int8 kernel
    against its plain version on the bf16 stage inputs. Returns the
    per-request records of A (bf16) and of the int8 kernel (or None)."""
    import torch.nn.functional as F

    from styler_tpu_torch.ops.resblock import (
        fused_resblock_stage,
        quantize_branch_params,
        resblock_stage_int8,
        resblock_stage_int8_plain,
        resblock_stage_plain,
    )

    stage_in, ks, dils = stage_inputs(torch, g, mel2b)
    taps = 2 * len(dils) * sum(ks)  # per output element and input channel
    rec_a = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0}
    rec_q = dict(rec_a) if int8 else None
    work = {"a": [0.0, 0.0], "q": [0.0, 0.0]}  # flops, bytes
    for i, x_bf in enumerate(stage_in):
        blocks = [getattr(g, f"resblocks_{i}_{j}") for j in range(len(ks))]
        B, T, C = x_bf.shape
        flops = 2.0 * B * T * C * C * taps
        lib_bf16 = None
        for dtype, tol, peak in ((torch.bfloat16, 3e-2, PEAK_BF16), (torch.float32, 1e-4, PEAK_F32)):
            x_in = x_bf.to(dtype).contiguous()
            bp = [tuple(t.detach().to(dtype) if t.dim() == 4 else t.detach().float()
                        for t in b.branch_params()) for b in blocks]
            with torch.no_grad():
                got = fused_resblock_stage(x_in, bp, ks, dils)
                torch.cuda.synchronize()
                want = resblock_stage_plain(x_in, bp, ks, dils)
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                check(bool(torch.isfinite(got).all()), f"{path} resblock stage {i} {dtype}: non-finite output")
                check(err <= tol * max(scale, 1.0),
                      f"{path} resblock stage {i} {dtype}: max |kernel - plain| {err} > {tol} x {scale}")
                ms = cuda_ms(torch, lambda: fused_resblock_stage(x_in, bp, ks, dils), 5)
                plain_ms = cuda_ms(torch, lambda: resblock_stage_plain(x_in, bp, ks, dils), 2)
                bpc = [tuple(t.permute(0, 3, 2, 1).contiguous() if t.dim() == 4 else t.to(dtype)
                             for t in b) for b in bp]  # [n_dil, Cout, Cin, k] for F.conv1d
                lib_ms = cuda_ms(torch, lambda: resblock_library(torch, F, x_in, bpc, ks, dils), 5)
            esz = x_in.element_size()
            n_bytes = 2 * B * T * C * esz + taps * C * C * esz + 2 * len(dils) * len(ks) * C * 4
            b_ms, b_by = bound(flops, peak, n_bytes)
            emit("kernels", kernel="resblock_stage", path=path, stage=i, shape=[B, T, C],
                 dtype=str(dtype), max_abs_err=err, out_scale=scale, tolerance=f"{tol} x max|plain|",
                 ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                 flops=flops, bytes=n_bytes, launches_per_request=2 * len(dils) * len(ks))
            if dtype == torch.bfloat16:  # the main path's dtype
                lib_bf16 = lib_ms
                for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms)):
                    rec_a[k] += v
                rec_a["max_abs_err"] = max(rec_a["max_abs_err"], err)
                work["a"][0] += flops
                work["a"][1] += n_bytes
        if not int8:
            continue
        # the int8 kernel on the bf16 stage input, weights quantised once
        x_in = x_bf.to(torch.bfloat16).contiguous()
        q = quantize_branch_params([b.branch_params() for b in blocks])
        with torch.no_grad():
            got = resblock_stage_int8(x_in, q, ks, dils)
            torch.cuda.synchronize()
            want = resblock_stage_int8_plain(x_in, q, ks, dils)
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            check(bool(torch.isfinite(got).all()), f"int8 stage {i}: non-finite output")
            check(err <= INT8_TOL * max(scale, 1.0),
                  f"int8 stage {i}: max |kernel - plain| {err} > {INT8_TOL} x {scale}")
            ms = cuda_ms(torch, lambda: resblock_stage_int8(x_in, q, ks, dils), 5)
            plain_ms = cuda_ms(torch, lambda: resblock_stage_int8_plain(x_in, q, ks, dils), 1)
        n_bytes = 2 * B * T * C * 2 + taps * C * C + 2 * 2 * len(dils) * len(ks) * C * 4
        b_ms, b_by = bound(flops, PEAK_INT8, n_bytes)
        emit("kernels", kernel="resblock_stage_int8", path=path, stage=i, shape=[B, T, C],
             dtype="int8 x int8 -> int32, bf16 in/out", max_abs_err=err, out_scale=scale,
             tolerance=f"{INT8_TOL} x max|plain| (int32 sums exact; f32 epilogue rounding, "
                       "one bf16 ulp of the output; a whole quantisation step would mean the "
                       "two disagree on a tile's scale)",
             ms=ms, plain_ms=plain_ms, library_ms=lib_bf16,
             library="cuDNN conv chain in bf16 (no int8 convolution in PyTorch)",
             bound_ms=b_ms, bound_by=b_by, ops=flops, bytes=n_bytes,
             launches_per_request=2 * len(dils) * len(ks))
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_bf16)):
            rec_q[k] += v
        rec_q["max_abs_err"] = max(rec_q["max_abs_err"], err)
        work["q"][0] += flops
        work["q"][1] += n_bytes
    rec_a["bound_ms"], rec_a["bound_by"] = bound(work["a"][0], PEAK_BF16, work["a"][1])
    if int8:
        rec_q["bound_ms"], rec_q["bound_by"] = bound(work["q"][0], PEAK_INT8, work["q"][1])
    return rec_a, rec_q


def phase_lstm(torch, model, cfg):
    """Kernel B's serving form vs plain on one BiLSTM layer of the audio
    encoder at the largest src bucket, B = 1, the asset's weights, inputs
    of post-ReLU scale."""
    from styler_tpu_torch.ops.lstm import lstm_recurrence, lstm_recurrence_plain, pack_gates, pack_w_hh
    from styler_tpu_torch.ops.recurrent import flip_padded

    dev = torch.device("cuda")
    enc = model.style_modeling.audio_encoder
    lstms = (enc.lstm_d, enc.lstm_p, enc.lstm_e, enc.lstm_r)
    T = cfg.src_buckets[-1]
    lengths = torch.tensor([T - 37], device=dev)  # a valid length below the bucket
    gen = torch.Generator(device="cpu").manual_seed(0)
    gates, w_hh, hiddens = [], [], []
    for m in lstms:
        p = m.layer_params()[0]
        x = torch.relu(torch.randn(1, T, p["fwd"]["w_ih"].shape[1], generator=gen)).to(dev)
        x[:, int(lengths[0]):] = 0
        for d in ("fwd", "bwd"):
            xd = x if d == "fwd" else flip_padded(x, lengths)
            gates.append(xd @ p[d]["w_ih"].detach().t() + p[d]["b_ih"].detach() + p[d]["b_hh"].detach())
            w_hh.append(p[d]["w_hh"].detach())
        hiddens.append(p["fwd"]["w_hh"].shape[1])
    hp = max(hiddens)
    g, w = pack_gates(gates, hp), pack_w_hh(w_hh, hp)
    with torch.no_grad():
        got = lstm_recurrence(g, w)
        torch.cuda.synchronize()
        want = lstm_recurrence_plain(g, w)
        err = (got - want).abs().max().item()
        tol = 1e-4  # exact f32 both sides, another sum order over 256 steps
        check(bool(torch.isfinite(got).all()), "lstm serving form: non-finite output")
        check(err <= tol, f"lstm serving form: max |kernel - plain| {err} > {tol}")
        ms = cuda_ms(torch, lambda: lstm_recurrence(g, w), 20)
        plain_ms = cuda_ms(torch, lambda: lstm_recurrence_plain(g, w), 2)
        # yardstick: cuDNN nn.LSTM, one bidirectional layer per branch on an
        # unpadded sequence (it also computes the input projection)
        libs = []
        for m, H in zip(lstms, hiddens):
            p = m.layer_params()[0]
            lstm = torch.nn.LSTM(p["fwd"]["w_ih"].shape[1], H, batch_first=True, bidirectional=True).to(dev)
            for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
                for n in ("w_ih", "w_hh", "b_ih", "b_hh"):
                    getattr(lstm, f"{n.replace('w_', 'weight_').replace('b_', 'bias_')}_l0{sfx}").copy_(p[d][n])
            libs.append((lstm, torch.relu(torch.randn(1, T, p["fwd"]["w_ih"].shape[1], generator=gen)).to(dev)))
        lib_ms = cuda_ms(torch, lambda: [lstm(xx) for lstm, xx in libs], 20)
    flops = sum(2 * T * 2.0 * 4 * H * H for H in hiddens)  # recurrent matvecs, both directions
    n_bytes = sum(2 * (T * 4 * H + 4 * H * H + T * H) * 4.0 for H in hiddens)
    b_ms, b_by = bound(flops, PEAK_F32, n_bytes)
    emit("kernels", kernel="lstm_recurrence", form="serving (h only)",
         shape={"S": len(gates), "B": 1, "T": T, "Hp": hp},
         hiddens=hiddens, valid_length=int(lengths[0]), max_abs_err=err, tolerance=tol,
         ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
         flops=flops, bytes=n_bytes, launches_per_request=2)
    n_layers = len(lstms[0].layer_params())
    return {"ms": n_layers * ms, "plain_ms": n_layers * plain_ms, "library_ms": n_layers * lib_ms,
            "bound_ms": n_layers * b_ms, "bound_by": b_by, "max_abs_err": err}


def phase_lstm_train(torch, model, cfg, batch_size):
    """Kernel B's training form (h, c, acts) and kernel C (BPTT backward)
    vs their plain versions on one BiLSTM layer of the audio encoder at
    the training path's shapes: the four necks' layer-1 weights of the
    asset, both directions (S = 8), B = batch_size, T = the largest src
    bucket, ragged valid lengths, dh_out from a seeded normal."""
    from styler_tpu_torch.ops.lstm import (
        lstm_backward, lstm_backward_plain, lstm_recurrence, lstm_recurrence_plain,
        pack_gates, pack_w_hh,
    )
    from styler_tpu_torch.ops.recurrent import flip_padded

    dev = torch.device("cuda")
    enc = model.style_modeling.audio_encoder
    lstms = (enc.lstm_d, enc.lstm_p, enc.lstm_e, enc.lstm_r)
    B, T = batch_size, cfg.src_buckets[-1]
    gen = torch.Generator(device="cpu").manual_seed(1)
    lengths = torch.randint(T // 2, T + 1, (B,), generator=gen)
    lengths[0] = T
    lengths = lengths.to(dev)
    valid = (torch.arange(T, device=dev)[None, :] < lengths[:, None])[..., None]
    gates, w_hh, hiddens, xs = [], [], [], []
    with torch.no_grad():
        for m in lstms:
            p = m.layer_params()[0]
            x = torch.relu(torch.randn(B, T, p["fwd"]["w_ih"].shape[1], generator=gen)).to(dev) * valid
            xs.append(x)
            for d in ("fwd", "bwd"):
                xd = x if d == "fwd" else flip_padded(x, lengths)
                gates.append(xd @ p[d]["w_ih"].t() + p[d]["b_ih"] + p[d]["b_hh"])
                w_hh.append(p[d]["w_hh"].detach())
                hiddens.append(p[d]["w_hh"].shape[1])
        hp = max(hiddens)
        g, w = pack_gates(gates, hp), pack_w_hh(w_hh, hp)
        S = len(gates)
        dh = torch.zeros(S, B, T, hp)
        for s_, H in enumerate(hiddens):  # no gradient ever reaches a padded unit
            dh[s_, ..., :H] = torch.randn(B, T, H, generator=gen)
        dh = dh.to(dev)

        # kernel B, training form
        h, c, acts = lstm_recurrence(g, w, save=True)
        torch.cuda.synchronize()
        h_p, c_p, acts_p = lstm_recurrence_plain(g, w, save=True)
        # exact f32 both sides, another sum order over 256 steps. h and the
        # activated gates are bounded by 1; c is not (it adds up to one per
        # step), so each array is held to 1e-4 of max(1, its scale).
        tol_b = 1e-4
        errs_b = {}
        for name, got, want in (("h", h, h_p), ("c", c, c_p), ("acts", acts, acts_p)):
            check(bool(torch.isfinite(got).all()), f"lstm training form: non-finite {name}")
            err, scale = (got - want).abs().max().item(), want.abs().max().item()
            errs_b[name] = {"max_abs_err": err, "scale": scale}
            check(err <= tol_b * max(scale, 1.0),
                  f"lstm training form {name}: max |kernel - plain| {err} > {tol_b} x {scale}")
        err_b = max(e["max_abs_err"] for e in errs_b.values())
        check(bool(torch.equal(lstm_recurrence(g, w), h)), "lstm: serving and training forms differ in h")
        ms_b = cuda_ms(torch, lambda: lstm_recurrence(g, w, save=True), 20)
        ms_b_serving = cuda_ms(torch, lambda: lstm_recurrence(g, w), 20)
        plain_ms_b = cuda_ms(torch, lambda: lstm_recurrence_plain(g, w, save=True), 1)

        # kernel C on the residuals kernel B saved
        dg, dw = lstm_backward(dh, acts, c, h, w)
        torch.cuda.synchronize()
        dg_p, dw_p = lstm_backward_plain(dh, acts, c, h, w)
        # exact f32 both sides: dgates chains 256 steps in another sum order,
        # dW sums B*T = 4096 terms in another order. 1e-4 of the plain
        # version's scale holds both (measured ~1e-6 and ~3e-6 of the scale).
        tol_c = 1e-4
        scale_dg, scale_dw = dg_p.abs().max().item(), dw_p.abs().max().item()
        err_dg, err_dw = (dg - dg_p).abs().max().item(), (dw - dw_p).abs().max().item()
        check(bool(torch.isfinite(dg).all() and torch.isfinite(dw).all()), "lstm backward: non-finite")
        check(err_dg <= tol_c * scale_dg, f"lstm backward dgates: {err_dg} > {tol_c} x {scale_dg}")
        check(err_dw <= tol_c * scale_dw, f"lstm backward dW: {err_dw} > {tol_c} x {scale_dw}")
        for s_, H in enumerate(hiddens):
            check(bool((dg[s_].reshape(B, T, 4, hp)[..., H:] == 0).all() and (dw[s_, H:] == 0).all()
                       and (dw[s_].reshape(hp, 4, hp)[..., H:] == 0).all()),
                  "lstm backward: padded units are not exactly 0")
        dg2, dw2 = lstm_backward(dh, acts, c, h, w)
        check(bool(torch.equal(dg, dg2) and torch.equal(dw, dw2)), "lstm backward: not deterministic")
        ms_c = cuda_ms(torch, lambda: lstm_backward(dh, acts, c, h, w), 20)
        plain_ms_c = cuda_ms(torch, lambda: lstm_backward_plain(dh, acts, c, h, w), 1)

    # yardstick: cuDNN nn.LSTM, one bidirectional layer per branch on the
    # padded batch (it also computes the input projection and its
    # gradients): forward in training mode for B, backward = (forward +
    # backward) - forward for C
    libs = []
    for m, x in zip(lstms, xs):
        p = m.layer_params()[0]
        H = p["fwd"]["w_hh"].shape[1]
        lstm = torch.nn.LSTM(x.shape[-1], H, batch_first=True, bidirectional=True).to(dev)
        with torch.no_grad():
            for d, sfx in (("fwd", ""), ("bwd", "_reverse")):
                for n in ("w_ih", "w_hh", "b_ih", "b_hh"):
                    getattr(lstm, f"{n.replace('w_', 'weight_').replace('b_', 'bias_')}_l0{sfx}").copy_(p[d][n])
        libs.append((lstm.train(), x.clone().requires_grad_(),
                     torch.randn(B, T, 2 * H, generator=gen).to(dev)))

    def lib_forward():
        return [lstm(x)[0] for lstm, x, _ in libs]

    def lib_forward_backward():
        torch.autograd.backward(lib_forward(), [cot for _, _, cot in libs])

    lib_f = cuda_ms(torch, lib_forward, 10)
    lib_fb = cuda_ms(torch, lib_forward_backward, 10)

    # work of the unpadded recurrences: the recurrent products (B: h . W;
    # C: dgates . W^T and h^T . dgates), each array read or written once
    n_rec = B * T
    flops_b = sum(n_rec * 2.0 * 4 * H * H for H in hiddens)
    bytes_b = sum((n_rec * (4 * H + H + H + 4 * H) + 4 * H * H) * 4.0 for H in hiddens)
    flops_c = sum(n_rec * 2 * 2.0 * 4 * H * H for H in hiddens)
    bytes_c = sum((n_rec * (H + 4 * H + H + H + 4 * H) + 2 * 4 * H * H) * 4.0 for H in hiddens)
    bb_ms, bb_by = bound(flops_b, PEAK_F32, bytes_b)
    bc_ms, bc_by = bound(flops_c, PEAK_F32, bytes_c)
    shape = {"S": S, "B": B, "T": T, "Hp": hp}
    emit("kernels", kernel="lstm_recurrence", form="training (h, c, acts)", shape=shape,
         hiddens=hiddens, valid_lengths=[int(v) for v in lengths.tolist()],
         max_abs_err=err_b, errors=errs_b, tolerance=f"{tol_b} x max(1, max|plain|) each",
         ms=ms_b, serving_form_ms_same_shape=ms_b_serving,
         plain_ms=plain_ms_b, library_ms=lib_f, library="cuDNN nn.LSTM forward, training mode",
         bound_ms=bb_ms, bound_by=bb_by, flops=flops_b, bytes=bytes_b, launches_per_step=4)
    emit("kernels", kernel="lstm_backward", shape=shape, hiddens=hiddens,
         max_abs_err_dgates=err_dg, scale_dgates=scale_dg, max_abs_err_dw=err_dw, scale_dw=scale_dw,
         tolerance=f"{tol_c} x max|plain| each", ms=ms_c, plain_ms=plain_ms_c,
         library_ms=lib_fb - lib_f, library="cuDNN nn.LSTM (forward+backward) - forward",
         library_forward_ms=lib_f, library_forward_backward_ms=lib_fb,
         bound_ms=bc_ms, bound_by=bc_by, flops=flops_c, bytes=bytes_c, launches_per_step=4)
    per_step = 4  # 2 layers x (main pass + DAT pass)
    rec_b = {"ms": per_step * ms_b, "plain_ms": per_step * plain_ms_b, "library_ms": per_step * lib_f,
             "bound_ms": per_step * bb_ms, "bound_by": bb_by, "max_abs_err": err_b}
    rec_c = {"ms": per_step * ms_c, "plain_ms": per_step * plain_ms_c,
             "library_ms": per_step * (lib_fb - lib_f), "bound_ms": per_step * bc_ms,
             "bound_by": bc_by, "max_abs_err": max(err_dg, err_dw)}
    return rec_b, rec_c


def run_requests(torch, synth, ref, spk, cfg, phase, smi, counters):
    """One warm-up request, then the 3 SENTENCES with wall times; checks
    shapes and finiteness. Returns the outputs and the launches of each
    counter during the 3 requests."""
    import numpy as np

    synth.synthesize(SENTENCES[0], ref, spk)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    M = cfg.mel_buckets[-1]
    outs = []
    for s in SENTENCES:
        t0 = time.perf_counter()
        out = synth.synthesize(s, ref, spk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        ml = out["mel_len"]
        check(0 < ml <= M, f"{phase}: mel_len {ml}")
        check(out["mel"].shape == (ml, cfg.n_mel_channels) and out["mel_noisy"].shape == out["mel"].shape,
              f"{phase}: mel shape")
        check(out["wav"].shape == (ml * cfg.hop_length,) == out["wav_noisy"].shape, f"{phase}: wav shape")
        for k in ("mel", "mel_noisy", "wav", "wav_noisy", "f0", "energy", "duration"):
            check(bool(np.isfinite(out[k]).all()), f"{phase}: non-finite {k}")
        outs.append(out)
        emit(phase, sentence=s, phonemes=int((~out["src_mask"][0]).sum()), mel_len=ml,
             wall_ms=wall_ms, card=smi)
    return outs, {name: fn.launches for name, fn in counters.items()}


def card_vs_cpu(torch, synth, cpu, g, ref, spk, phase) -> None:
    """The request of SENTENCES[0] on the card (``g``, from ``synth``)
    against the same request on ``cpu``, a Synthesizer with
    ``device="cpu"`` (the kernels' plain versions)."""
    import numpy as np

    c = cpu.synthesize(SENTENCES[0], ref, spk)
    check(c["mel_len"] == g["mel_len"], f"{phase}: mel_len card {g['mel_len']} vs cpu {c['mel_len']}")
    res = {}
    # f32 acoustic model, TF32 off: sums in another order only
    for k, tol in (("duration", 1e-4), ("mel", 1e-3), ("mel_noisy", 1e-3)):
        scale = max(float(np.abs(c[k]).max()), 1.0)
        err = float(np.abs(g[k] - c[k]).max())
        res[k] = {"max_abs_err": err, "tolerance": tol * scale}
        check(err <= tol * scale, f"{phase} {k}: {err} > {tol} x {scale}")
    # bf16 vocoder: one bf16 rounding flip of an early conv moves samples a
    # lot (iSTFTNet emits its phase in bf16), so sample SNR is fragile (bf16
    # vs f32 of the same path measures 5 to 17 dB); hold the log-mels of
    # the waveforms instead (bf16 vs f32 measures 0.03 to 0.06, natural log)
    for k in ("wav", "wav_noisy"):
        c64 = c[k].astype(np.float64)
        snr = float(10 * np.log10((c64 ** 2).sum() / max(((g[k] - c64) ** 2).sum(), 1e-30)))
        mae = float(np.abs(cpu.frontend(g[k])[0] - cpu.frontend(c[k])[0]).mean())
        res[k] = {"log_mel_mae": mae, "tolerance": 0.1, "snr_db": snr}
        check(mae < 0.1, f"{phase} {k}: log-mel MAE {mae}")
    # the vocoder in f32 on one mel batch: kernel A's f32 mode against the
    # plain version end to end, exact f32 on both sides
    mel_in = torch.from_numpy(np.stack([c["mel"], c["mel_noisy"]]))
    for s_ in (synth, cpu):
        s_.generator.compute_dtype = torch.float32
    with torch.no_grad():
        w_card = synth.generator(mel_in.cuda()).cpu().numpy().astype(np.float64)
        w_cpu = cpu.generator(mel_in).numpy().astype(np.float64)
    snr = float(10 * np.log10((w_cpu ** 2).sum() / max(((w_card - w_cpu) ** 2).sum(), 1e-30)))
    res["wav_f32_vocoder"] = {"snr_db": snr, "min_snr_db": 50.0}
    check(snr > 50.0, f"{phase} f32 vocoder: SNR {snr} dB")
    emit(phase, sentence=SENTENCES[0], **res)


def phase_hifigan(torch, cfg, mel2b, ref, spk, smi):
    """The HiFi-GAN serving path: kernel A and its int8 form against their
    plain versions on the four stages (hifigan_kernels); 3 requests through
    kernel A (main_hifigan); the same requests through the int8 kernel with
    STYLER_TPU_INT8_VOCODER=1 (int8); one request card vs CPU
    (hifigan_card_vs_cpu). Returns the kernel records and launch counts."""
    import numpy as np

    from styler_tpu_torch.ops.lstm import lstm_recurrence
    from styler_tpu_torch.ops.resblock import fused_resblock_stage, resblock_stage_int8
    from styler_tpu_torch.synthesis import load_synthesizer

    counters = {"resblock_stage": fused_resblock_stage, "resblock_stage_int8": resblock_stage_int8,
                "lstm_recurrence": lstm_recurrence}
    per_request = 4 * 18  # 4 stages x 3 branches x 3 dilations x 2 convs

    t0 = time.perf_counter()
    synth = load_synthesizer(cfg, vocoder_arch="HiFi-GAN")
    check(synth.config.vocoder == "HiFi-GAN" and not synth.generator.quantize, "not the HiFi-GAN path")
    emit("load_hifigan", seconds=time.perf_counter() - t0, device=str(synth.device))
    rec_a, rec_q = phase_resblock(torch, synth.generator, mel2b, "HiFi-GAN", int8=True)

    outs, launches = run_requests(torch, synth, ref, spk, cfg, "main_hifigan", smi, counters)
    emit("main_hifigan_launches", **launches)
    check(launches["resblock_stage"] == per_request * len(SENTENCES)
          and launches["resblock_stage_int8"] == 0,
          f"HiFi-GAN path: kernel A launched {launches['resblock_stage']} times, the int8 kernel "
          f"{launches['resblock_stage_int8']} (expected {per_request} and 0 per request)")
    phase_profile(torch, synth, SENTENCES[-1], ref, spk, "profile_hifigan")

    os.environ["STYLER_TPU_INT8_VOCODER"] = "1"
    try:
        t0 = time.perf_counter()
        synth_q = load_synthesizer(cfg, vocoder_arch="HiFi-GAN")
    finally:
        del os.environ["STYLER_TPU_INT8_VOCODER"]
    check(synth_q.generator.quantize, "STYLER_TPU_INT8_VOCODER=1 did not select the int8 form")
    emit("load_int8", seconds=time.perf_counter() - t0)
    outs_q, launches_q = run_requests(torch, synth_q, ref, spk, cfg, "int8", smi, counters)
    emit("int8_launches", **launches_q)
    check(launches_q["resblock_stage_int8"] == per_request * len(SENTENCES)
          and launches_q["resblock_stage"] == 0,
          f"int8 path: int8 kernel launched {launches_q['resblock_stage_int8']} times, kernel A "
          f"{launches_q['resblock_stage']} (expected {per_request} and 0 per request)")
    phase_profile(torch, synth_q, SENTENCES[-1], ref, spk, "profile_int8")
    # quality of the int8 vocoder against the bf16 one: fail only on a
    # non-finite result (checked above) or a log-mel MAE above 1.0; the JAX
    # package's own measurement on the trained weights was about 0.37
    maes = []
    for o, oq in zip(outs, outs_q):
        for k in ("wav", "wav_noisy"):
            maes.append(float(np.abs(synth.frontend(oq[k])[0] - synth.frontend(o[k])[0]).mean()))
    emit("int8_quality", log_mel_mae_vs_bf16=maes, mean=sum(maes) / len(maes), fail_above=1.0)
    check(max(maes) <= 1.0, f"int8 vocoder log-mel MAE vs bf16 {max(maes)} > 1.0")
    del synth_q
    torch.cuda.empty_cache()

    card_vs_cpu(torch, synth, load_synthesizer(cfg, vocoder_arch="HiFi-GAN", device="cpu"),
                outs[0], ref, spk, "hifigan_card_vs_cpu")
    del synth
    torch.cuda.empty_cache()
    return rec_a, rec_q, launches, launches_q


def profile_rows(torch, prof):
    """(device kernels, host operators) of a profile, each as (name, count,
    own ms) sorted by time. Device-side events only for the first: an aten
    op's own row repeats its kernels' time."""
    rows = [
        (e.key, e.count, e.self_device_time_total / 1e3)
        for e in prof.key_averages()
        # kernels and copies only: an annotation's device row (the
        # optimizer's "Optimizer.step#...") repeats the kernels under it
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False) and "#" not in e.key
    ]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    host = sorted(
        ((e.key, e.count, e.self_cpu_time_total / 1e3) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CPU),
        key=lambda r: -r[2],
    )
    return rows, host


def emit_profile(phase, rows, host, wall_ms, **kw):
    busy_ms = sum(r[2] for r in rows)
    emit(phase, wall_ms=wall_ms,
         device_busy_ms=busy_ms if rows else "not measured",
         device_idle_share=(1 - busy_ms / wall_ms) if rows else "not measured",
         host_op_ms=sum(r[2] for r in host), host_ops=sum(r[1] for r in host),
         port_kernels=[{"kernel": k[:90], "count": n, "ms": ms} for k, n, ms in rows
                       if "lstm_" in k or "resblock_" in k],
         top=[{"kernel": k[:90], "count": n, "ms": ms} for k, n, ms in rows[:15]],
         top_host=[{"op": k[:60], "count": n, "ms": ms} for k, n, ms in host[:10]], **kw)


def phase_train(torch, cfg, smi, workdir):
    """The training main path: example dataset on disk -> Trainer.fit on
    CUDA from the trained asset, batch 16, dropout on. Returns the trainer
    and the launch counts of the whole run."""
    from styler_tpu_torch.ops.lstm import lstm_backward, lstm_recurrence
    from styler_tpu_torch.train.example import write_example_dataset
    from styler_tpu_torch.train.trainer import Trainer

    n_steps = 4  # one warm-up, three timed
    t0 = time.perf_counter()
    ds_cfg = write_example_dataset(os.path.join(workdir, "data"), cfg.replace(log_step=1), 64, seed=0)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer = Trainer(ds_cfg, init="asset", ckpt_dir=os.path.join(workdir, "ckpt"),
                      log_dir=os.path.join(workdir, "log"))
    check(trainer.device.type == "cuda" and trainer.state.model.training, "trainer not on the card")
    emit("train_setup", utterances=len(trainer.dataset), batches_per_epoch=trainer.steps_in_epoch,
         batch_size=ds_cfg.batch_size, write_dataset_s=t_write, build_trainer_s=time.perf_counter() - t0,
         parameters=sum(p.numel() for p in trainer.state.model.parameters()))
    model = trainer.state.model
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    stats_before = {k: v.clone() for k, v in model.named_buffers() if "running" in k}

    torch.cuda.reset_peak_memory_stats()
    lstm_recurrence.launches = lstm_recurrence.training_launches = lstm_backward.launches = 0
    seen = {"b": 0, "c": 0, "t": time.perf_counter()}
    walls = []

    def on_step(state, comps):
        torch.cuda.synchronize()
        now = time.perf_counter()
        wall_ms, seen["t"] = (now - seen["t"]) * 1e3, now
        vals = {k: float(v) for k, v in comps.items()}
        check(len(vals) == 10 and all(math.isfinite(v) for v in vals.values()),
              f"step {state.step}: non-finite loss component {vals}")
        gn = float(state.grad_norm)
        check(math.isfinite(gn) and gn > 0, f"step {state.step}: gradient norm {gn}")
        check(all(p.grad is not None for p in model.parameters()), "a parameter has no gradient")
        b = lstm_recurrence.training_launches - seen["b"]
        c = lstm_backward.launches - seen["c"]
        seen["b"], seen["c"] = lstm_recurrence.training_launches, lstm_backward.launches
        check(b == 4 and c == 4, f"step {state.step}: kernel B (training form) launched {b} "
                                 f"times and kernel C {c} times, expected 4 and 4")
        walls.append(wall_ms)
        emit("train", step=state.step, wall_ms=wall_ms, warm_up=state.step == 1, grad_norm=gn,
             kernel_b_training_launches=b, kernel_c_launches=c, card=smi, **vals)
        seen["t"] = time.perf_counter()

    logs = []
    trainer.fit(n_steps, on_step=on_step, log=logs.append)
    torch.cuda.synchronize()
    state = trainer.state
    check(state.step == n_steps, f"step counter {state.step} after {n_steps} steps")
    check(lstm_recurrence.launches == lstm_recurrence.training_launches,
          "a serving-form launch on the training path")
    changed = sum(int(not torch.equal(before[k], v.detach())) for k, v in model.named_parameters())
    check(changed >= 0.95 * len(before), f"only {changed} of {len(before)} parameter leaves changed")
    moved = sum(int(not torch.equal(stats_before[k], v)) for k, v in model.named_buffers()
                if k in stats_before)
    check(moved == len(stats_before) > 0, f"{moved} of {len(stats_before)} BatchNorm statistics moved")
    check(os.path.exists(os.path.join(workdir, "ckpt", f"step_{n_steps}.pt")), "no checkpoint written")
    check(sum("\"step\"" in line for line in logs) == n_steps, "one metrics line per step expected")
    launches = {"lstm_recurrence_training": lstm_recurrence.training_launches,
                "lstm_backward": lstm_backward.launches}
    emit("train_summary", steps=n_steps, timed_step_wall_ms=walls[1:],
         mean_timed_step_wall_ms=sum(walls[1:]) / len(walls[1:]),
         leaves_changed=changed, leaves=len(before), batchnorm_statistics_moved=moved,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30, card=smi, **launches)
    check(all(n > 0 for n in launches.values()), f"a kernel of the training path never launched: {launches}")
    return trainer, launches


def phase_train_profile(torch, trainer) -> None:
    """Where one train step's time goes (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    batch = next(trainer.batches())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, host = profile_rows(torch, prof)
    t0 = time.perf_counter()
    trainer.step(batch)
    torch.cuda.synchronize()
    emit_profile("train_profile", rows, host, wall_ms,
                 unprofiled_step_wall_ms=(time.perf_counter() - t0) * 1e3,
                 shapes={k: list(v.shape) for k, v in batch.items() if k in ("src_seq", "mel_target")})


def phase_train_card_vs_cpu(torch, cfg) -> None:
    """One step's forward and backward without dropout at B = 2, L = 32,
    M = 128: the card (kernels B and C) against device="cpu" (their plain
    versions), from the same weights and batch, for freshly initialised
    weights and for the trained asset.

    Components within 1e-4 relative. Every gradient leaf is held two ways:
    its RMS error against the CPU leaf's RMS (or a tenth of the whole CPU
    gradient's RMS where the leaf's own is smaller: the attention key
    biases have a gradient of exactly 0 in theory and hold rounding noise
    only), and its largest element error against max(1, max |cpu grad|).
    The second is the looser one on
    purpose: a ReLU whose input lies within f32 rounding of zero takes the
    other branch on the other device, which moves ONE whole element of the
    upstream gradient into a bias leaf (seen on fresh weights: decoder
    pos_ffn w_1 bias and kernel off by 2.7e-3 of their scale on the card,
    the kernel's error confined to the taps of one output channel, while
    every CPU leaf is within 3e-6 of an f64 run, and isolated conv,
    attention and matmul gradients on the card within 2e-6 of f64). The
    trained asset on this random batch is also badly conditioned in f32
    for the leaves at the far end of the backward pass (CPU f32 against CPU
    f64: 2.6e-3 of the scale on the text encoder's first w_qs/bias). Both
    tolerances still catch a wrong kernel or a TF32 product (1e-3 per
    product, on every leaf).
    """
    import numpy as np

    from styler_tpu_torch.core.checkpoint import default_acoustic_asset, flatten_tree, load_acoustic_npz
    from styler_tpu_torch.core.convert import to_flax_tree
    from styler_tpu_torch.data.dataset import batch_to_device
    from styler_tpu_torch.train import compute_gradients, create_train_state, train_state_from_flax
    from styler_tpu_torch.train.example import example_batch

    params, stats = load_acoustic_npz(default_acoustic_asset())
    batch = example_batch(cfg, B=2, L=32, M=128, seed=0)
    makers = {  # name: (L2 tolerance, element tolerance, state maker)
        "fresh": (1e-3, 1e-2, lambda dev: create_train_state(cfg, torch.Generator().manual_seed(0), dev)),
        "asset": (1e-2, 1e-2, lambda dev: train_state_from_flax(cfg, params, stats, device=dev)),
    }
    out = {}
    for name, (tol_l2, tol_max, make) in makers.items():
        res = {}
        for dev in ("cuda", "cpu"):
            state = make(dev)
            comps = compute_gradients(state, batch_to_device(batch, dev), None, cfg.dat_weight)
            res[dev] = ({k: float(v) for k, v in comps.items()},
                        flatten_tree(to_flax_tree(state.model, grads=True)[0]))
        comp_err = {}
        for k, want in res["cpu"][0].items():
            comp_err[k] = abs(res["cuda"][0][k] - want) / max(abs(want), 1e-12)
            check(comp_err[k] <= 1e-4,
                  f"train card vs cpu ({name}), component {k}: {res['cuda'][0][k]} vs {want}")
        worst = {"l2": (None, -1.0), "max": (None, -1.0, 0)}
        n_all = sum(v.size for v in res["cpu"][1].values())
        rms_all = math.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in res["cpu"][1].values()) / n_all)
        for k, want in res["cpu"][1].items():
            diff = np.abs(res["cuda"][1][k].astype(np.float64) - want)
            rms = math.sqrt(float((want.astype(np.float64) ** 2).mean()))
            l2 = math.sqrt(float((diff ** 2).mean())) / max(rms, 0.1 * rms_all)
            mx = float(diff.max()) / max(1.0, float(np.abs(want).max()))
            if l2 > worst["l2"][1]:
                worst["l2"] = (k, l2)
            if mx > worst["max"][1]:  # and how many elements carry an error of that order
                worst["max"] = (k, mx, int((diff > 0.1 * diff.max()).sum()))
        check(worst["l2"][1] <= tol_l2, f"train card vs cpu ({name}): gradient leaf {worst['l2'][0]} "
                                        f"off by {worst['l2'][1]} of its RMS")
        check(worst["max"][1] <= tol_max, f"train card vs cpu ({name}): gradient leaf {worst['max'][0]} "
                                          f"has an element off by {worst['max'][1]} of its scale")
        out[name] = {"components_max_rel_err": max(comp_err.values()), "tolerance_components": 1e-4,
                     "gradient_leaves": len(res["cpu"][1]),
                     "worst_l2_leaf": worst["l2"][0], "worst_l2_rel_err": worst["l2"][1],
                     "tolerance_l2": f"{tol_l2} x max(rms(cpu leaf), 0.1 rms(cpu gradient))",
                     "cpu_gradient_rms": rms_all,
                     "worst_element_leaf": worst["max"][0], "worst_element_rel_err": worst["max"][1],
                     "elements_within_a_tenth_of_that_error": worst["max"][2],
                     "tolerance_element": f"{tol_max} x max(1, max|cpu grad|)"}
    emit("train_card_vs_cpu", **out,
         deterministic_algorithms=torch.are_deterministic_algorithms_enabled(),
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)


def phase_profile(torch, synth, sentence, ref, spk, phase="profile") -> None:
    """Where one request's time goes: torch.profiler's device time by
    kernel, and the device's busy share of the request's wall time."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    synth.text_to_ids(sentence)
    text_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synth.synthesize(sentence, ref, spk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, host = profile_rows(torch, prof)
    emit_profile(phase, rows, host, wall_ms, sentence=sentence, text_to_ids_ms=text_ms)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from styler_tpu_torch.core.config import default_config
    from styler_tpu_torch.core.device import resolve_device
    from styler_tpu_torch.data.audio_io import read_wav_int
    from styler_tpu_torch.ops import build
    from styler_tpu_torch.ops.lstm import lstm_backward, lstm_recurrence
    from styler_tpu_torch.ops.resblock import fused_resblock_stage, resblock_stage_int8
    from styler_tpu_torch.synthesis import extract_reference_features, load_synthesizer

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit("device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    resolve_device(None)

    # 2. build, into a fresh directory so every kernel compiles here
    os.makedirs(os.path.join(ROOT, "styler_tpu_torch", "_build"), exist_ok=True)
    os.environ["STYLER_TORCH_BUILD_DIR"] = tempfile.mkdtemp(
        prefix="smoke-", dir=os.path.join(ROOT, "styler_tpu_torch", "_build"))
    t0 = time.perf_counter()
    libs = build.build()
    emit("build", seconds=time.perf_counter() - t0, libraries=libs,
         ptxas=ptxas_summary(build.ptxas_report))

    # 3. kernels vs plain, at the main path's shapes
    cfg = default_config()
    t0 = time.perf_counter()
    synth = load_synthesizer(cfg)
    emit("load", seconds=time.perf_counter() - t0, device=str(synth.device))
    M = cfg.mel_buckets[-1]
    val = np.load(os.path.join(ROOT, "assets", "vocoder", "val_mel.npy")).astype(np.float32)
    mel2b = torch.from_numpy(np.stack([np.resize(val, (M, 80)), np.resize(val[::-1], (M, 80))])).cuda()
    rec_a, _ = phase_resblock(torch, synth.generator, mel2b, "iSTFTNet")
    rec_b = phase_lstm(torch, synth.model, cfg)
    rec_b_train, rec_c = phase_lstm_train(torch, synth.model, cfg, cfg.batch_size)

    # 4. the main path: 3 requests after one warm-up request
    sr, wav = read_wav_int(os.path.join(ROOT, "assets", "vocoder", "val", "val_0000.wav"))
    check(sr == cfg.sampling_rate, f"reference wav at {sr} Hz")
    ref = extract_reference_features(wav.astype(np.float32), cfg, synth.frontend)
    spk = np.random.default_rng(0).standard_normal(cfg.speaker_embed_dim).astype(np.float32)
    spk /= np.linalg.norm(spk)
    lstm_recurrence.training_launches = 0
    outs, launches = run_requests(torch, synth, ref, spk, cfg, "main", smi, {
        "resblock_stage": fused_resblock_stage, "lstm_recurrence": lstm_recurrence,
        "resblock_stage_int8": resblock_stage_int8, "lstm_backward": lstm_backward})
    emit("main_launches", **launches)
    check(launches["resblock_stage"] > 0 and launches["lstm_recurrence"] > 0,
          f"a kernel of the main path never launched: {launches}")
    check(lstm_recurrence.training_launches == 0 and launches["lstm_backward"] == 0
          and launches["resblock_stage_int8"] == 0, "serving launched a training or an int8 kernel")
    phase_profile(torch, synth, SENTENCES[-1], ref, spk)

    # 5. card vs CPU on the first request
    card_vs_cpu(torch, synth, load_synthesizer(cfg, device="cpu"), outs[0], ref, spk, "card_vs_cpu")
    del synth
    torch.cuda.empty_cache()

    # 6-9. the HiFi-GAN serving path, exact and int8
    rec_h, rec_q, launches_h, launches_q = phase_hifigan(torch, cfg, mel2b, ref, spk, smi)

    # 10-12. the training main path
    workdir = tempfile.mkdtemp(prefix="smoke-train-", dir=os.path.join(ROOT, "styler_tpu_torch", "_build"))
    try:
        trainer, train_launches = phase_train(torch, cfg, smi, workdir)
        phase_train_profile(torch, trainer)
        del trainer
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    phase_train_card_vs_cpu(torch, cfg)

    common = {"route": "cuda"}
    kernels = [
        {"name": "resblock_stage", **common, "source": "styler_tpu_torch/csrc/resblock.cu",
         "replaces": "styler_tpu/ops/pallas_resblock.py:311",
         "launches": launches["resblock_stage"], "max_abs_err": rec_a["max_abs_err"],
         "ms": rec_a["ms"], "plain_ms": rec_a["plain_ms"], "bound_ms": rec_a["bound_ms"],
         "bound_by": rec_a["bound_by"], "library_ms": rec_a["library_ms"],
         # the same kernel on the HiFi-GAN path (4 stages, C = 256..32), per request
         "hifigan": {"launches": launches_h["resblock_stage"], **rec_h}},
        {"name": "resblock_stage_int8", **common, "source": "styler_tpu_torch/csrc/resblock_int8.cu",
         "replaces": "styler_tpu/ops/pallas_resblock.py:311 (quantize=True)",
         "launches": launches_q["resblock_stage_int8"], "max_abs_err": rec_q["max_abs_err"],
         "ms": rec_q["ms"], "plain_ms": rec_q["plain_ms"], "bound_ms": rec_q["bound_ms"],
         "bound_by": rec_q["bound_by"], "library_ms": rec_q["library_ms"]},
        {"name": "lstm_recurrence", **common, "source": "styler_tpu_torch/csrc/lstm.cu",
         "replaces": "styler_tpu/ops/pallas_lstm.py:76",
         "launches": launches["lstm_recurrence"], "max_abs_err": rec_b["max_abs_err"],
         "ms": rec_b["ms"], "plain_ms": rec_b["plain_ms"], "bound_ms": rec_b["bound_ms"],
         "bound_by": rec_b["bound_by"], "library_ms": rec_b["library_ms"],
         # its training form, per train step (4 launches), on the training path
         "training_form": {"launches": train_launches["lstm_recurrence_training"], **rec_b_train}},
        {"name": "lstm_backward", **common, "source": "styler_tpu_torch/csrc/lstm_bwd.cu",
         "replaces": "styler_tpu/ops/pallas_lstm.py:169",
         "launches": train_launches["lstm_backward"], "max_abs_err": rec_c["max_abs_err"],
         "ms": rec_c["ms"], "plain_ms": rec_c["plain_ms"], "bound_ms": rec_c["bound_ms"],
         "bound_by": rec_c["bound_by"], "library_ms": rec_c["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
