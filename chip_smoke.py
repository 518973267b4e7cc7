#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``styler_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name and power limit; fails without a CUDA device.
2. build   — builds every kernel from ``styler_tpu_torch/csrc`` (one nvcc
             per source, in parallel) and prints the ptxas register /
             shared-memory / spill summary of every kernel entry; fails if
             an entry of kernel A, of its int8 form, of kernel B or of
             kernel C spills.
3. kernels — each kernel against its plain PyTorch version at the shapes
             the main paths give it, with the tolerance stated, and CUDA-event
             times of the kernel, the plain version, a PyTorch library call
             computing the same function (a yardstick the port never calls)
             and the card's lower bound for the same work: kernel A (resblock
             stage), kernel B (LSTM recurrence) in its serving form at the
             serving shapes and in its training form at the training shapes,
             kernel C (LSTM BPTT backward) at the training shapes. The
             LSTM lines carry ns per step, their launch plan
             (``ops/lstm.py:lstm_launch_plan``: instance, threads,
             registers, shared memory; C's dW tile and split) and the SM
             clock, power draw and limit sampled right after the timing;
             C's line also the CUDA-event times of its walk alone and of
             its dW product alone, and a ``kernels_summary`` line the dW
             product's own bound beside its time (worked out, not
             measured, so kept off the measured ``kernels`` records).
             (Kernel A on the iSTFTNet stages here; on HiFi-GAN's in 7.)
             Each kernel A line also carries the launch plan of its bf16
             mode (tile [BM, BN], grid and shared memory of the largest-halo
             conv, the fewest CTAs per SM over the stage's convs, every
             conv's plan) beside ``bound_ms``, the whole stage kept on
             chip; a ``kernels_summary`` line sums a path's stages and
             carries ``hbm_floor_ms``, the bytes the 18 launches of each
             stage move at 3.35 TB/s (worked out, not measured).
3b. speaker — the trained speaker encoder (``SpeakerEmbedder(cfg,
             backend="native")``, cuDNN f32 convolutions) on the card
             against ``device="cpu"`` on the four validation wavs: finite,
             unit norm within 1e-4, card vs CPU within 1e-6 per entry, the
             four embeddings apart (smallest pairwise cosine distance >
             1e-3); a control run with TF32 on must differ from the CPU
             by more than 1e-6, so the limit tells the f32 forward from a
             TF32 one; the fallback tier equal on both; ms of the host
             features and of the device forward apart, and the forward's
             GFLOP and bound.
4. main    — ``load_synthesizer(default_config())`` on CUDA, reference
             features of ``assets/vocoder/val/val_0000.wav``, the trained
             encoder's embedding of that wav (phase 3b), and ``synthesize``
             on 3 sentences; checks shapes, finiteness and that kernels A and
             B were launched.
   A profiled request follows (device time by kernel, idle share).
5. card_vs_cpu — one request again with ``device="cpu"`` (plain versions);
             durations and mels at f32 tolerance, waveforms by log-mel
             distance (bf16), the f32 vocoder by SNR.
6. the rest of the Synthesizer, on the same iSTFTNet synthesizer at the
   default buckets, each phase with its launches of kernels A and B (and
   a check that kernel C, B's training form and the int8 kernel never
   launched). Each phase that runs the kernels first makes one untimed
   call in which every call of kernel A and kernel B is recorded with its
   inputs and output (``Capture``) and held against its plain version on
   those inputs at phase 3's tolerances (``hold_kernels``): kernel A at 32
   grid rows (batch, mix), 10 (inspect) and 4 (long), kernel B's serving
   form at B = 16, 4, 2 and 1 on the rows' own ragged gates. Then the
   counted, timed call:
   warmup  — ``synth.warmup()``: 25 forwards, seconds;
   batch   — ``synthesize_batch`` over 16 distinct rows (BATCH_SENTENCES x
             two references and speakers), all in one (src, mel) bucket
             pair, so each row's request alone runs at the batch's buckets:
             wall ms, audio seconds per wall second; every row's shapes
             and finiteness; every row, clean and noisy, against
             ``synthesize()`` of its request (``hold_request``): the same
             mel_len and rounded durations, log-durations, f0 and energy
             (before ``bucketize``) within 1e-4 of their scale, waveforms by
             log-mel MAE < 0.1, and the mel within 2e-4 + 1e-4 rel where
             the two fell into the same pitch and energy bins; at least
             half of the 32 mels must be held;
   profile_batch — the same call under ``torch.profiler`` (device busy,
             idle share, kernel rows);
   long    — a 335-phoneme sentence, two chunks of the 256 bucket: chunk
             count, lengths (the sum of the chunks'), finiteness, wall ms;
   inspect — the ten-row grid of one sentence: titles, finiteness, the
             float16 values against the same grid left in f32 (half ulp),
             its ``T+D+P+E+S`` / ``T+D+P+E+S+N`` rows against
             ``synthesize``'s clean / noisy outputs as in batch, the mel
             within float16's half ulp of the scale (+ 1e-4), wall ms;
   mix     — ``mix_and_match`` of two sentences x two references: 32
             titles, ``00000`` / ``11111`` against the two single requests
             (same checks), wall ms and the decode bucket M_comb.
   A row and its single request run other algorithms (other batch
   sizes), so a prediction within f32 rounding of a pitch or energy bin
   edge can take the other bin in one of them (one flip moved a
   1024-frame mel by 0.12); such a row's mel is reported with the frames
   that differ, and everything else of the row is held;
   residual_off — the acoustic forward at B = 1, buckets (128, 1024),
             with and without the residual decode: CUDA-event ms of each
             and its device busy ms (torch.profiler), the clean mels equal
             within 2e-4 + 1e-4 rel.
6b. serving from reference audio, on the same synthesizer, with a
   reference directory written under ``styler_tpu_torch/_build/``
   (``val_0000.wav`` as ``p901_001`` with a TextGrid whose phones tier has
   silence at both ends, ``val_0001.wav`` as ``p902_001`` with a
   precomputed ``spker_embed`` npy):
   reference — ``load_reference``: the trim to the TextGrid's span (mel_len
             = the durations' sum), the npy embedding where it exists, the
             encoder's embedding of the trimmed wav where not (equal to
             ``embed_wav`` within 1e-6); ms of a new reference, and its f0,
             mel and speaker (asset load, embedding) parts apart;
   serve   — the server's handler (``styler_tpu_torch/cli/serve.py:Server``)
             on the request list of ``tests/test_cli.py:203-222``: once under
             ``Capture`` (every call of kernels A and B held against its
             plain version), then with each request's launches counted (A 36
             and B 2 on each synthesizing request, none on the others) and
             each reply checked as that test does (wav length = mel_len x
             256); the single request's wav file against ``synthesize``
             in-process (log-mel MAE < 0.1 after int16 rounding); ms of a
             request on a cached reference;
   serve_cli — ``python -m styler_tpu_torch.cli.serve`` as a child process
             on the card (it inherits ``STYLER_TORCH_BUILD_DIR`` and builds
             nothing): ping, one request, shutdown; exit code 0, every stdout
             line a JSON reply to a request, the wav's length; seconds to the
             first reply; then ``python -m styler_tpu_torch.cli.synthesize``
             once: clean and noisy wavs and the mel npy written and finite.
6c. the serving bundle (``styler_tpu_torch/core/export.py``), on the same
   synthesizer and reference directory:
   bundle_capture — ``save_serving_bundle`` at the default buckets (5 x 5)
             for batches 1 and 8 (50 entries), ``BundleSynthesizer`` on it
             and its ``warmup()``: every entry one eager forward and one
             CUDA-graph capture (kernel A 72 and B 4 launches an entry),
             then a replay; export, load and capture seconds, the graph
             count, ``torch.cuda.memory_reserved`` before and after (and
             after ``empty_cache``: the graphs' pool);
   bundle  — ``main``'s 3 requests and an 8-row batch (BATCH_SENTENCES on
             one reference) through the graphs against the live eager
             ``synthesize`` / ``synthesize_batch``: bit-equal expected, any
             key that differs named with its error and held as a batch row
             is (``hold_request``); one entry captured again under
             ``Capture`` and replayed with a real request, so kernels A and
             B are held against their plain versions on the calls recorded
             while capturing (the tensors live in the graph's pool and hold
             the replay's values); a replay and an eager request under
             ``torch.profiler`` (``bundle_profile``: A 36 and B 2 kernels in
             the replay's trace, wall, device busy, idle share); the
             synchronisations of a bundle call (1), of a bundle request and
             of an eager one (``set_sync_debug_mode("warn")``); request wall
             ms, graph and eager in turns;
   serve_bundle — ``Server.handle`` over the ``BundleSynthesizer`` on the
             ``serve`` request list (no kernel launched: every entry is
             captured), the replies checked as ``serve`` does, the single
             request's file against the live ``synthesize``, three timed
             requests on a cached reference; then ``python -m
             styler_tpu_torch.cli.serve --bundle DIR --warmup`` as a child
             process that builds nothing (its warmup seconds from its log).
7. hifigan_kernels — ``load_synthesizer(cfg, vocoder_arch="HiFi-GAN")``;
             kernel A (bf16 and f32) and the int8 kernel against their plain
             versions on the four HiFi-GAN stage inputs of the 2B batch of
             1024-frame mels ([2, 8192, 256] .. [2, 262144, 32]), with times,
             the cuDNN bf16 conv chain as yardstick and the bound; each int8
             line carries its launch plan, and its kernels_summary line the
             HBM floor of its 18 launches (f32 y and carry). Then one stage
             whose branches have
             dilations of their own (branch_dilations), kernel against
             plain in bf16 and int8.
8. main_hifigan — 3 requests after a warm-up through HiFi-GAN; kernel A
             launches 72 times per request, the int8 kernel never; then a
             profiled request (profile_hifigan) and one bundle entry at the
             first request's buckets (bundle_hifigan: launches at capture,
             none at replay, the replay against the live request).
9. int8    — the same requests with ``STYLER_TPU_INT8_VOCODER=1`` set before
             construction: the int8 kernel 72 times per request, kernel A
             never; a profiled request (profile_int8); the same bundle entry
             in the int8 form (bundle_int8); log-mel MAE of the
             int8 waveforms against the bf16 ones (fails only above 1.0 or on
             a non-finite result).
10. hifigan_card_vs_cpu — one HiFi-GAN request against ``device="cpu"``.
11. train  — writes a 64-utterance example dataset made from a seed to disk
             and runs ``Trainer(...).fit`` on CUDA from the committed trained
             weights at full width, batch 16, dropout on: one warm-up step and
             three timed ones. Checks the 10 loss components, the gradient
             norm, that every parameter had a gradient and nearly all changed,
             that the BatchNorm statistics moved, and that kernel B's training
             form and kernel C were each launched 4 times per step.
12. train_profile — one more step under ``torch.profiler``.
13. train_card_vs_cpu — one step's loss components and every gradient leaf,
             without dropout, on the card against ``device="cpu"``.

14. bf16 — (inside 6c's reference dir, on the same f32 synthesizer)
             ``load_synthesizer`` with ``compute_dtype="bfloat16"``: one
             request under ``Capture`` (kernels A and B held against their
             plain versions, kernel B's gates and weights float32), the 3
             requests of ``main`` (A 36 and B 2 each, nothing else), each
             against the port's bf16 on the CPU and against the card's f32
             (``hold_bf16_request``: log-durations, and where the rounded
             durations agree f0, energy and mels, within twice the CPU
             port's own bf16-vs-f32 distance plus half a bf16 step of the
             scale; a duration may round differently only within bf16 noise
             of the edge; waveforms by log-mel MAE < 0.1); one request
             profiled in each dtype (``bf16_profile_bf16`` / ``_f32``: wall,
             device busy, idle share, ``cudnn_conv_ms``); the 16-row batch in
             each dtype (``bf16_batch_*``: wall, busy, audio s per wall s); one
             bundle entry at B = 1 in each dtype (``bf16_bundle``: the
             compute dtype recorded in the manifest, launches at capture,
             none at replay, the bf16 replay bit-equal to bf16 eager,
             request walls in turns).
15. reference_ckpt — (after 10) a full-width reference
             ``checkpoint_<step>.pth.tar`` written from the committed
             asset's trees (``reference_state_dict``, the importer's layout
             inverted, with ``module.`` and what the importer must ignore):
             loaded with no vocoder named it must serve HiFi-GAN, its request
             bit-equal to the asset's with ``vocoder_arch="HiFi-GAN"``, kernel
             A 72 launches; with ``STYLER_TPU_INT8_VOCODER=1`` the int8 kernel
             72 and its prep pass 4; load ms.
16. random — ``ckpt_path="random"`` twice: the same weights; a finite
             request (A 36, B 2).
17. train_serve — (after 12) ``save_checkpoint`` of the trained state,
             then ``load_synthesizer`` on its ``step_<N>.pt`` and on the
             checkpoint directory: each request bit-equal to a Synthesizer
             built from ``to_flax_tree(state.model)``; the exporter
             (``python -m styler_tpu_torch.tools.export_acoustic_asset``) on
             the directory: its ``.npz`` loads to the float16-rounded trees
             bit for bit and serves a finite request; save and export
             seconds, the file's size.

Then the script's total seconds (``total``), the ``{"kernels": [...]}`` line,
the nvidia-smi line, and as the last line ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line is printed. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import functools
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
# the 16-row batch: these 8 sentences x two references; each sentence has
# 33 to 64 phonemes, so every row lies in the same src bucket (64)
BATCH_SENTENCES = (
    "She sells sea shells by the sea shore every summer morning.",
    "A gentle breeze carried the scent of rain across the quiet valley.",
    "Please call me back when you have a moment to talk about the plan.",
    "The old library kept its rarest books behind a locked glass door.",
    "We walked along the river until the lights of the town came into view.",
    "Every student in the class finished the test before the bell rang.",
    "The train to the coast leaves at seven and arrives just after noon.",
    "He painted the small wooden boat a bright shade of blue.",
)


#: the script's start, for the seconds each phase line carries (``t_s``)
T_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw, "t_s": time.perf_counter() - T_START}), flush=True)


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


def clocks() -> str:
    """SM clock, power draw and power limit, sampled now."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def bound(flops: float, peak: float, n_bytes: float):
    t_ops, t_bytes = flops / peak * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ptxas_summary(report: dict) -> dict:
    """Registers, static shared memory and spills of every kernel entry in
    each library's ptxas report (one entry per template instance)."""
    out = {}
    for name, log in report.items():
        entries = []
        for chunk in log.split("Compiling entry function ")[1:]:
            fn = re.match(r"'(\S+)'", chunk)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
            regs = re.search(r"Used (\d+) registers", chunk)
            smem = re.search(r"Used \d+ registers[^\n]*?(\d+) bytes smem", chunk)
            if not (fn and spill and regs):
                continue
            entries.append({
                "function": fn.group(1), "registers": int(regs.group(1)),
                "static_smem_bytes": int(smem.group(1)) if smem else 0,
                "spill_store_bytes": int(spill.group(1)), "spill_load_bytes": int(spill.group(2)),
            })
        out[name] = entries
    return out


def resblock_library(torch, F, x, bp, kernel_sizes, dilations):
    """Yardstick: the unfused stage as a chain of cuDNN F.conv1d calls in
    the compute dtype (channels-first), as the flax ResBlock1 composes it.
    ``dilations``: one tuple per branch."""
    xc = x.transpose(1, 2)
    total = None
    for (w1, b1, w2, b2), k, dils in zip(bp, kernel_sizes, dilations):
        xb = xc
        for i, d in enumerate(dils):
            xt = F.conv1d(F.leaky_relu(xb, 0.1), w1[i], b1[i], padding=d * (k - 1) // 2, dilation=d)
            xt = F.conv1d(F.leaky_relu(xt, 0.1), w2[i], b2[i], padding=(k - 1) // 2)
            xb = xb + xt
        total = xb if total is None else total + xb
    return (total / len(bp)).transpose(1, 2)


def stage_launch_bytes(B, T, C, kernel_sizes, dilations, y_bytes, out_bytes, w_bytes):
    """Bytes the launches of one stage (18 at 3 branches x 3 dilations)
    move through HBM, each read and write once, as ``ops/resblock.py``
    chains them: per pair, conv1 reads the f32 carry and writes y
    (``y_bytes`` per element: the compute dtype in kernel A, f32 in the
    int8 form), conv2 reads y and the f32 residual and writes the f32 carry
    (the branch sum, or the final output of ``out_bytes``, after the last
    dilation), plus weights (``w_bytes`` each) and biases (and the int8
    form's scales). ``dilations``: one tuple per branch."""
    n = B * T * C
    total = 0
    for bi, (k, dils) in enumerate(zip(kernel_sizes, dilations)):
        for i, _ in enumerate(dils):
            scales = C * 4 if w_bytes == 1 else 0  # the int8 weights' per-channel scales
            weights = 2 * (k * C * C * w_bytes + C * 4 + scales)
            last = i == len(dils) - 1
            total += 4 * n + y_bytes * n + y_bytes * n + 4 * n + weights
            if last and bi > 0:
                total += 4 * n  # the branch sum read
            total += out_bytes * n if last and bi == len(kernel_sizes) - 1 else 4 * n
    return total


def stage_taps(kernel_sizes, dilations):
    """Taps per output element and input channel of one stage: two convs
    per dilation of each branch. ``dilations``: one tuple per branch."""
    return 2 * sum(k * len(ds) for k, ds in zip(kernel_sizes, dilations))


def stage_plans(B, T, C, kernel_sizes, dilations, int8=False):
    """The launch plan (bf16 kernel A, or the int8 form) of every distinct
    conv of a stage (conv1 at each dilation of its branch, conv2 at
    dilation 1), largest halo first, and their summary: the largest conv's
    tile and grid, the fewest CTAs per SM, the most shared memory, and
    whether the weights stay resident (every conv, none, or some)."""
    from styler_tpu_torch.ops.resblock import bf16_launch_plan, int8_launch_plan

    plan = int8_launch_plan if int8 else bf16_launch_plan
    convs = sorted({(k, d) for k, ds in zip(kernel_sizes, dilations) for d in (*ds, 1)},
                   key=lambda kd: -((kd[0] - 1) // 2 * kd[1]))
    plans = [{"k": k, "dil": d, **plan(B, T, C, k, d)} for k, d in convs]
    weights = {p["weights"] for p in plans}
    return {"tile": plans[0]["tile"], "threads": plans[0]["threads"], "grid": plans[0]["grid"],
            "ctas_per_sm": min(p["ctas_per_sm"] for p in plans),
            "smem_bytes": max(p["smem_bytes"] for p in plans),
            "weights": weights.pop() if len(weights) == 1 else "resident and ring",
            "plans": plans}


def stage_inputs(torch, g, mel2b):
    """The input of every resblock stage of generator ``g`` for the 2B mel
    batch, as the main path produces it (kernel A runs the stages)."""
    import torch.nn.functional as F

    from styler_tpu_torch.ops.resblock import fused_resblock_stage

    ks = tuple(g.config.resblock_kernel_sizes)
    dils = tuple(tuple(d) for d in g.config.resblock_dilation_sizes)
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
        stage_launches,
    )

    stage_in, ks, dils = stage_inputs(torch, g, mel2b)
    taps = stage_taps(ks, dils)  # per output element and input channel
    n_launch = stage_launches(dils, len(ks))
    rec_a = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0}
    rec_q = dict(rec_a) if int8 else None
    # HBM floors (bytes over the memory rate, not measured) go on the
    # kernels_summary lines, apart from the measured kernel records
    summary = {"stages_ms": [], "stages_library_ms": [], "stages_hbm_floor_ms": [], "hbm_floor_ms": 0.0}
    summary_q = {"stages_ms": [], "stages_hbm_floor_ms": [], "hbm_floor_ms": 0.0}
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
            n_bytes = 2 * B * T * C * esz + taps * C * C * esz + n_launch * C * 4
            b_ms, b_by = bound(flops, peak, n_bytes)
            floor_ms = stage_launch_bytes(B, T, C, ks, dils, esz, esz, esz) / HBM_BYTES_PER_S * 1e3
            if dtype == torch.bfloat16:
                geometry = stage_plans(B, T, C, ks, dils)
            else:  # the f32 kernel's fixed 64 x 64 tile, static shared memory
                geometry = {"tile": [64, 64], "grid": [-(-T // 64), -(-C // 64), B],
                            "ctas_per_sm": "not queried", "smem_bytes": 34816}
            emit("kernels", kernel="resblock_stage", path=path, stage=i, shape=[B, T, C],
                 dtype=str(dtype), max_abs_err=err, out_scale=scale, tolerance=f"{tol} x max|plain|",
                 ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                 **geometry,
                 flops=flops, bytes=n_bytes, launches_per_request=n_launch)
            if dtype == torch.bfloat16:  # the main path's dtype
                summary["stages_ms"].append(ms)
                summary["stages_library_ms"].append(lib_ms)
                summary["stages_hbm_floor_ms"].append(floor_ms)
                summary["hbm_floor_ms"] += floor_ms
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
        n_bytes = 2 * B * T * C * 2 + taps * C * C + 2 * n_launch * C * 4
        b_ms, b_by = bound(flops, PEAK_INT8, n_bytes)
        # y and the carry in f32, the stage output in bf16, int8 weights
        floor_ms = stage_launch_bytes(B, T, C, ks, dils, 4, 2, 1) / HBM_BYTES_PER_S * 1e3
        geometry = stage_plans(B, T, C, ks, dils, int8=True)
        emit("kernels", kernel="resblock_stage_int8", path=path, stage=i, shape=[B, T, C],
             dtype="int8 x int8 -> int32, bf16 in/out", max_abs_err=err, out_scale=scale,
             tolerance=f"{INT8_TOL} x max|plain| (int32 sums exact; f32 epilogue rounding, "
                       "one bf16 ulp of the output; a whole quantisation step would mean the "
                       "two disagree on a tile's scale)",
             ms=ms, plain_ms=plain_ms, library_ms=lib_bf16,
             library="cuDNN conv chain in bf16 (no int8 convolution in PyTorch)",
             bound_ms=b_ms, bound_by=b_by, **geometry, ops=flops,
             bytes=n_bytes, launches_per_request=n_launch)
        summary_q["stages_ms"].append(ms)
        summary_q["stages_hbm_floor_ms"].append(floor_ms)
        summary_q["hbm_floor_ms"] += floor_ms
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_bf16)):
            rec_q[k] += v
        rec_q["max_abs_err"] = max(rec_q["max_abs_err"], err)
        work["q"][0] += flops
        work["q"][1] += n_bytes
    rec_a["bound_ms"], rec_a["bound_by"] = bound(work["a"][0], PEAK_BF16, work["a"][1])
    emit("kernels_summary", kernel="resblock_stage", path=path, dtype="torch.bfloat16",
         ms=rec_a["ms"], library_ms=rec_a["library_ms"], bound_ms=rec_a["bound_ms"], **summary)
    if int8:
        rec_q["bound_ms"], rec_q["bound_by"] = bound(work["q"][0], PEAK_INT8, work["q"][1])
        emit("kernels_summary", kernel="resblock_stage_int8", path=path, ms=rec_q["ms"],
             bound_ms=rec_q["bound_ms"], **summary_q)
    return rec_a, rec_q


def phase_branch_dilations(torch):
    """One stage whose branches have dilations of their own,
    ((1, 3), (1, 3, 5), (2, 4, 6)), at HiFi-GAN stage 1's shape [2, 65536,
    128] with seeded weights: kernel A (bf16) and the int8 kernel against
    their plain versions, 16 launches each."""
    import numpy as np

    from styler_tpu_torch.ops.resblock import (
        fused_resblock_stage,
        quantize_branch_params,
        resblock_stage_int8,
        resblock_stage_int8_plain,
        resblock_stage_plain,
        stage_launches,
    )

    ks, dils = (3, 7, 11), ((1, 3), (1, 3, 5), (2, 4, 6))
    B, T, C = 2, 65536, 128
    n = Launches()
    rng = np.random.default_rng(6)
    dev = torch.device("cuda")

    def normal(shape, std):
        return torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)).to(dev)

    bp = [(normal((len(d), k, C, C), 0.5 / np.sqrt(k * C)), normal((len(d), C), 0.01),
           normal((len(d), k, C, C), 0.5 / np.sqrt(k * C)), normal((len(d), C), 0.01))
          for k, d in zip(ks, dils)]
    x = normal((B, T, C), 1.0).to(torch.bfloat16)
    out = {}
    with torch.no_grad():
        for form, fn, counter, plain, params, tol in (
            ("bf16", fused_resblock_stage, "resblock_stage", resblock_stage_plain,
             [tuple(t.to(torch.bfloat16) if t.dim() == 4 else t for t in b) for b in bp], 3e-2),
            ("int8", resblock_stage_int8, "resblock_stage_int8", resblock_stage_int8_plain,
             quantize_branch_params(bp), INT8_TOL),
        ):
            n.reset()
            got = fn(x, params, ks, dils)
            torch.cuda.synchronize()
            launches = n.read()[counter]
            want = plain(x, params, ks, dils)
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            check(bool(torch.isfinite(got).all()), f"branch dilations {form}: non-finite output")
            check(launches == stage_launches(dils, len(ks)) == 16,
                  f"branch dilations {form}: {launches} launches, expected 16")
            check(err <= tol * max(scale, 1.0),
                  f"branch dilations {form}: max |kernel - plain| {err} > {tol} x {scale}")
            out[form] = {"max_abs_err": err, "out_scale": scale, "tolerance": f"{tol} x max|plain|",
                         "launches": launches, "ms": cuda_ms(torch, lambda: fn(x, params, ks, dils), 5)}
    emit("branch_dilations", shape=[B, T, C], kernel_sizes=ks, dilations=dils, **out)


def phase_lstm(torch, model, cfg):
    """Kernel B's serving form vs plain on one BiLSTM layer of the audio
    encoder at the largest src bucket, B = 1, the asset's weights, inputs
    of post-ReLU scale."""
    from styler_tpu_torch.ops.lstm import (
        lstm_launch_plan, lstm_recurrence, lstm_recurrence_plain, pack_gates, pack_w_hh,
    )
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
        clock = clocks()
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
         ms=ms, ns_per_step=ms * 1e6 / T, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
         bound_by=b_by, plan=lstm_launch_plan(hp, len(gates), 1)["recurrence"],
         clocks_sm_power_draw_limit=clock, flops=flops, bytes=n_bytes, launches_per_request=2)
    n_layers = len(lstms[0].layer_params())
    return {"ms": n_layers * ms, "plain_ms": n_layers * plain_ms, "library_ms": n_layers * lib_ms,
            "bound_ms": n_layers * b_ms, "bound_by": b_by, "max_abs_err": err,
            "ns_per_step": ms * 1e6 / T}


def phase_lstm_train(torch, model, cfg, batch_size):
    """Kernel B's training form (h, c, acts) and kernel C (BPTT backward)
    vs their plain versions on one BiLSTM layer of the audio encoder at
    the training path's shapes: the four necks' layer-1 weights of the
    asset, both directions (S = 8), B = batch_size, T = the largest src
    bucket, ragged valid lengths, dh_out from a seeded normal."""
    from styler_tpu_torch.ops.lstm import (
        lstm_backward, lstm_backward_plain, lstm_launch_plan, lstm_recurrence,
        lstm_recurrence_plain, pack_gates, pack_w_hh,
    )
    from styler_tpu_torch.ops.recurrent import flip_padded
    from styler_tpu_torch.tools.lstm_steps import walk_dw_split

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
        clock_b = clocks()
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
        clock_c = clocks()
        split_c = walk_dw_split(dh, acts, c, h, w)
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
    # C's dW product alone: h^T . dgates, h and dgates read once, dW written
    dwb_ms, dwb_by = bound(sum(n_rec * 2.0 * 4 * H * H for H in hiddens), PEAK_F32,
                         sum((n_rec * (H + 4 * H) + 4 * H * H) * 4.0 for H in hiddens))
    shape = {"S": S, "B": B, "T": T, "Hp": hp}
    plan = lstm_launch_plan(hp, S, B)
    emit("kernels", kernel="lstm_recurrence", form="training (h, c, acts)", shape=shape,
         hiddens=hiddens, valid_lengths=[int(v) for v in lengths.tolist()],
         max_abs_err=err_b, errors=errs_b, tolerance=f"{tol_b} x max(1, max|plain|) each",
         ms=ms_b, ns_per_step=ms_b * 1e6 / T, serving_form_ms_same_shape=ms_b_serving,
         plan=plan["recurrence"], clocks_sm_power_draw_limit=clock_b, plain_ms=plain_ms_b, library_ms=lib_f, library="cuDNN nn.LSTM forward, training mode",
         bound_ms=bb_ms, bound_by=bb_by, flops=flops_b, bytes=bytes_b, launches_per_step=4)
    emit("kernels", kernel="lstm_backward", shape=shape, hiddens=hiddens,
         max_abs_err_dgates=err_dg, scale_dgates=scale_dg, max_abs_err_dw=err_dw, scale_dw=scale_dw,
         tolerance=f"{tol_c} x max|plain| each", ms=ms_c, ns_per_step=ms_c * 1e6 / T,
         walk_ms=split_c["walk_ms"], dw_ms=split_c["dw_ms"],
         plan=plan["backward"], clocks_sm_power_draw_limit=clock_c, plain_ms=plain_ms_c,
         library_ms=lib_fb - lib_f, library="cuDNN nn.LSTM (forward+backward) - forward",
         library_forward_ms=lib_f, library_forward_backward_ms=lib_fb,
         bound_ms=bc_ms, bound_by=bc_by, flops=flops_c, bytes=bytes_c, launches_per_step=4)
    emit("kernels_summary", kernel="lstm_backward", part="dw", shape=shape, dw_ms=split_c["dw_ms"],
         dw_bound_ms=dwb_ms, dw_bound_by=dwb_by)
    per_step = 4  # 2 layers x (main pass + DAT pass)
    rec_b = {"ms": per_step * ms_b, "plain_ms": per_step * plain_ms_b, "library_ms": per_step * lib_f,
             "bound_ms": per_step * bb_ms, "bound_by": bb_by, "max_abs_err": err_b,
             "ns_per_step": ms_b * 1e6 / T}
    rec_c = {"ms": per_step * ms_c, "plain_ms": per_step * plain_ms_c,
             "library_ms": per_step * (lib_fb - lib_f), "bound_ms": per_step * bc_ms,
             "bound_by": bc_by, "max_abs_err": max(err_dg, err_dw), "ns_per_step": ms_c * 1e6 / T,
             "walk_ms": per_step * split_c["walk_ms"], "dw_ms": per_step * split_c["dw_ms"]}
    return rec_b, rec_c


class Launches:
    """The launch counters of every kernel wrapper: ``reset()`` sets them
    to 0, ``read()`` returns them."""

    def __init__(self):
        from styler_tpu_torch.ops.lstm import lstm_backward, lstm_recurrence
        from styler_tpu_torch.ops.resblock import fused_resblock_stage, resblock_stage_int8

        self.fns = {"resblock_stage": (fused_resblock_stage, "launches"),
                    "resblock_stage_int8": (resblock_stage_int8, "launches"),
                    "resblock_stage_int8_prep": (resblock_stage_int8, "prep_launches"),
                    "lstm_recurrence": (lstm_recurrence, "launches"),
                    "lstm_recurrence_training": (lstm_recurrence, "training_launches"),
                    "lstm_backward": (lstm_backward, "launches")}

    def reset(self) -> None:
        for fn, attr in self.fns.values():
            setattr(fn, attr, 0)

    def read(self) -> dict:
        return {name: getattr(fn, attr) for name, (fn, attr) in self.fns.items()}

    def check_serving(self, phase: str, a: int, b: int) -> dict:
        """Kernel A launched ``a`` times and kernel B's serving form ``b``
        times since ``reset()``; kernel C, B's training form and the int8
        kernel never."""
        n = self.read()
        check(n["resblock_stage"] == a and n["lstm_recurrence"] == b
              and n["lstm_recurrence_training"] == n["lstm_backward"] == 0
              and n["resblock_stage_int8"] == n["resblock_stage_int8_prep"] == 0,
              f"{phase}: launches {n}, expected kernel A {a}, kernel B {b} and no other")
        return {"resblock_stage": n["resblock_stage"], "lstm_recurrence": n["lstm_recurrence"],
                "others": 0}


def run_requests(torch, synth, ref, spk, cfg, phase, smi):
    """One warm-up request, then the 3 SENTENCES with wall times; checks
    shapes and finiteness. Returns the outputs and the launches of every
    counter (``Launches``) during the 3 requests."""
    import numpy as np

    synth.synthesize(SENTENCES[0], ref, spk)
    torch.cuda.synchronize()
    n = Launches()
    n.reset()
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
    return outs, n.read()


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
    dtypes = [s_.generator.compute_dtype for s_ in (synth, cpu)]
    try:
        for s_ in (synth, cpu):
            s_.generator.compute_dtype = torch.float32
        with torch.no_grad():
            w_card = synth.generator(mel_in.cuda()).cpu().numpy().astype(np.float64)
            w_cpu = cpu.generator(mel_in).numpy().astype(np.float64)
    finally:
        for s_, dt in zip((synth, cpu), dtypes):
            s_.generator.compute_dtype = dt
    snr = float(10 * np.log10((w_cpu ** 2).sum() / max(((w_card - w_cpu) ** 2).sum(), 1e-30)))
    res["wav_f32_vocoder"] = {"snr_db": snr, "min_snr_db": 50.0}
    check(snr > 50.0, f"{phase} f32 vocoder: SNR {snr} dB")
    emit(phase, sentence=SENTENCES[0], **res)


class Capture:
    """Inside ``with Capture(synth) as cap``, every call of kernel A
    (``fused_resblock_stage``, the iSTFTNet stages) and of kernel B
    (``lstm_recurrence``, the BiLSTM layers) is recorded with its inputs
    and its output in ``cap.calls[name]`` as (args, kwargs, output), and
    every output of ``synth._forward`` in ``cap.forwards``. The calls run
    as they would without it, so the recorded outputs are the path's own.
    A phase resets its launch counts after its captured call."""

    def __init__(self, synth):
        import styler_tpu_torch.ops.lstm as lstm_mod
        import styler_tpu_torch.vocoder.istft_net as istft_mod

        self.synth = synth
        self.sites = {"resblock_stage": (istft_mod, "fused_resblock_stage"),
                      "lstm_recurrence": (lstm_mod, "lstm_recurrence")}
        self.calls = {name: [] for name in self.sites}
        self.forwards = []

    @staticmethod
    def _record(fn, into):
        # wraps copies the wrapper's counters onto the spy: a wrapper
        # counts its launches on its module's name for it, which is the
        # spy while the capture lasts
        @functools.wraps(fn)
        def spy(*a, **kw):
            out = fn(*a, **kw)
            into.append((a, kw, out))
            return out
        return spy

    def __enter__(self):
        self.saved = {name: getattr(mod, attr) for name, (mod, attr) in self.sites.items()}
        for name, (mod, attr) in self.sites.items():
            setattr(mod, attr, self._record(self.saved[name], self.calls[name]))
        self.synth._forward = self._record(self.synth._forward, self.forwards)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.sites.items():
            setattr(mod, attr, self.saved[name])
        del self.synth._forward


def hold_kernels(torch, what, cap) -> dict:
    """Every call of kernel A and kernel B that ``cap`` recorded on a
    path (the path's own inputs, its own output) against the kernel's
    plain version on the same inputs, at phase 3's tolerances: kernel A
    (bf16) 3e-2 x max(1, max|plain|), kernel B 1e-4 x max(1, max|plain|)
    (|h| < 1, so 1e-4 as in phase 3). Returns each call's shape and error."""
    from styler_tpu_torch.ops.lstm import lstm_recurrence_plain
    from styler_tpu_torch.ops.resblock import resblock_stage_plain

    out = {}
    for name, plain, tol in (("resblock_stage", resblock_stage_plain, 3e-2),
                             ("lstm_recurrence", lstm_recurrence_plain, 1e-4)):
        check(len(cap.calls[name]) > 0, f"{what}: no call of {name} to hold")
        out[name] = []
        for a, kw, got in cap.calls[name]:
            with torch.no_grad():
                want = plain(*a, **kw)
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            limit = tol * max(scale, 1.0)
            check(bool(torch.isfinite(got).all()) and err <= limit,
                  f"{what}: {name} at {list(a[0].shape)}: max |kernel - plain| {err} > {limit}")
            out[name].append({"shape": list(a[0].shape), "max_abs_err": err, "out_scale": scale,
                              "tolerance": limit})
            del want
    return out


def bin_flips(np, bins, a, b) -> dict:
    """The frames where two results of one request with the same
    durations fall into different pitch or energy bins of the embedding
    lookups (``bucketize`` of the f32 predictions; ``bins`` = the model's
    (pitch, energy) edges). Empty where they agree."""
    out = {}
    for key, edges in zip(("f0", "energy"), bins):
        frames = np.nonzero(np.searchsorted(edges, a[key]) != np.searchsorted(edges, b[key]))[0]
        if len(frames):
            out[f"{key}_bin_frames"] = frames.tolist()
    return out


def uncast(synth, fn):
    """``fn()`` with the Synthesizer's output compression cut to the trim:
    the same computation, its values left in f32 (the wav scaled by 32767,
    unrounded, which the unpacking divides back)."""
    hop = synth.config.hop_length
    synth._compress = lambda mel, wav, p, e, n: (mel[:, :n], wav[:, : n * hop] * 32767.0, p[:, :n], e[:, :n])
    try:
        return fn()
    finally:
        del synth._compress


def near(np, a, b):
    """max |a - b| and whether every element lies within the f32 bound of
    a mel, 2e-4 + 1e-4 x |b| (``tests/test_synthesis.py:135-147``)."""
    diff = np.abs(a - b)
    return float(diff.max()), bool(np.all(diff <= 2e-4 + 1e-4 * np.abs(b)))


def near_scale(np, a, b):
    """max |a - b| and whether it is within 1e-4 of b's scale,
    max(1, max |b|): the f32 bound of a prediction (f0 is in Hz, so an
    element's own size says nothing of its rounding)."""
    err = float(np.abs(a - b).max())
    return err, err <= 1e-4 * max(1.0, float(np.abs(b).max()))


def hold_request(np, frontend, bins, what, got, want, f16=False, durations=None) -> dict:
    """A row of a batch, grid or mix (``got``) against the single request
    it must equal (``want``, from ``synthesize``). Fails unless:

    - the mel_len is the same and, with ``durations`` = (rounded
      durations of the row, of the request, over its phonemes), every
      phoneme's rounded duration is the same;
    - the continuous predictions, which no rounding step feeds, agree
      within 1e-4 of their scale (``near_scale``): the log-durations (with ``durations``,
      given as ``got["log_d"]`` / ``want["log_d"]``), and f0 and energy
      before ``bucketize`` (a grid or mix row passes them from ``uncast``,
      left in f32);
    - the waveforms agree by log-mel MAE < 0.1 (bf16 vocoder; int16 in a
      grid or mix row);
    - where the row and the request fall into the same pitch and energy
      bins (``bin_flips``), the mel agrees within 2e-4 + 1e-4 x |want|,
      or with ``f16`` within float16's half ulp of the scale + 1e-4.

    A prediction within f32 rounding of a bin edge can take the other bin
    in one of the two (other batch sizes run other algorithms; one such
    flip moved a 1024-frame mel by 0.12); such a row is held on everything
    else, and its mel is reported with the frames, not held. Returns the
    row's record; ``held`` says whether its mel was held."""
    check(got["mel_len"] == want["mel_len"], f"{what}: mel_len {got['mel_len']}, alone {want['mel_len']}")
    rec = {"mel_len": got["mel_len"]}
    keys = ("f0", "energy")
    if durations is not None:
        check(np.array_equal(*durations), f"{what}: a rounded duration differs from its request's")
        keys = ("log_d",) + keys
    for key in keys:
        err, ok = near_scale(np, got[key], want[key])
        check(ok, f"{what}: {key} off its request's by {err}")
        rec[f"{key}_max_abs_err"] = err
    mae = float(np.abs(frontend(got["wav"])[0] - frontend(want["wav"])[0]).mean())
    check(mae < 0.1, f"{what}: wav log-mel MAE {mae} against its request's")
    rec["wav_log_mel_mae"] = mae
    flips = bin_flips(np, bins, got, want)
    if flips:
        return {**rec, "bin_flips": flips, "held": False}
    if f16:
        err = float(np.abs(got["mel"] - want["mel"]).max())
        ok = err <= 2.0 ** -11 * float(np.abs(want["mel"]).max()) + 1e-4
    else:
        err, ok = near(np, got["mel"], want["mel"])
    check(ok, f"{what}: mel off its request's by {err}")
    return {**rec, "mel_max_abs_err": err, "held": True}


def hold_f16(np, frontend, bins, what, got, raw, want) -> dict:
    """A grid or mix row (``got``: float16 values, int16 wav; ``raw``: the
    same row left in f32 by ``uncast``): the float16 values are ``raw``'s
    rounded (within the half ulp of the scale + 1e-4), and the row is its
    single request (``hold_request`` with ``f16``; f0 and energy from
    ``raw``)."""
    for key in ("mel", "f0", "energy"):
        err = float(np.abs(got[key] - raw[key]).max())
        tol = 2.0 ** -11 * float(np.abs(raw[key]).max()) + 1e-4
        check(got["mel_len"] == raw["mel_len"] and err <= tol, f"{what}: float16 {key} off its f32 value by {err}")
    return hold_request(np, frontend, bins, what, {**got, "f0": raw["f0"], "energy": raw["energy"]},
                        want, f16=True)


def phase_serving(torch, synth, cfg, ref, ref2, spk, spk2, smi) -> None:
    """The rest of the Synthesizer on the card (iSTFTNet, trained weights,
    default buckets): warmup, a 16-row synthesize_batch (timed, profiled,
    every row held to its single request), a chunked long sentence, the
    inspection grid and mix-and-match (each held to single requests), and
    the acoustic forward with and without the residual decode. Kernel A
    and kernel B are counted on every phase, nothing else may launch, and
    on every phase that runs them each of their calls is held against its
    plain version on the phase's own inputs (``hold_kernels``), in an
    untimed call before the counted one."""
    import numpy as np
    import torch.nn.functional as F

    from styler_tpu_torch.core.config import bucket_for

    per_vocode = 2 * 18  # iSTFTNet: 2 stages x 18 launches, all rows at once
    per_encode = 2  # one kernel-B launch per BiLSTM layer, all rows at once
    n = Launches()
    sm = synth.model.style_modeling
    bins = (sm.pitch_bins.cpu().numpy(), sm.energy_bins.cpu().numpy())
    frontend = synth.frontend

    # warmup: one forward per (batch, src bucket, mel bucket)
    n.reset()
    t0 = time.perf_counter()
    count = synth.warmup()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(count == len(cfg.src_buckets) * len(cfg.mel_buckets) == 25, f"warmup: {count} forwards")
    emit("warmup", seconds=seconds, forwards=count,
         launches=n.check_serving("warmup", per_vocode * count, per_encode * count), card=smi)

    # batch: 16 distinct (sentence, reference, speaker) rows that share
    # one pair of buckets, so that each row's request alone runs at the
    # batch's buckets too (the predictors' convs and the audio encoder's
    # GroupNorm see the padding, in the JAX model as well)
    rows = [(s, (ref, ref2)[j], (spk, spk2)[j]) for s in BATCH_SENTENCES for j in (0, 1)]
    sentences, refs, spks = (list(c) for c in zip(*rows))
    ids = [synth.text_to_ids(s) for s in sentences]
    own = {(bucket_for(len(i), cfg.src_buckets), bucket_for(r.mel_len, cfg.mel_buckets))
           for i, r in zip(ids, refs)}
    check(len(rows) == 16 and len(own) == 1, f"batch: the rows lie in the buckets {own}")
    with Capture(synth) as cap:
        synth.synthesize_batch(sentences, refs, spks)
        torch.cuda.synchronize()
    kernels_held = hold_kernels(torch, "batch", cap)
    fwd = cap.forwards[0][2][0]
    check(len(cap.forwards) == 1 and [c["shape"][0] for c in kernels_held["resblock_stage"]] == [32, 32]
          and [c["shape"][1] for c in kernels_held["lstm_recurrence"]] == [16, 16],
          f"batch: kernel shapes {kernels_held}")
    log_d = fwd.log_d_prediction.cpu().numpy()
    del cap
    n.reset()
    t0 = time.perf_counter()
    res = synth.synthesize_batch(sentences, refs, spks)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = n.check_serving("batch", per_vocode, per_encode)
    check(fwd.mel_len.tolist() == [r["mel_len"] for r in res], "batch: mel_len differs between two calls")
    M = cfg.mel_buckets[-1]
    for i, r in enumerate(res):
        ml = r["mel_len"]
        check(0 < ml <= M and r["mel"].shape == r["mel_noisy"].shape == (ml, cfg.n_mel_channels)
              and r["wav"].shape == r["wav_noisy"].shape == (ml * cfg.hop_length,)
              and r["f0"].shape == r["energy"].shape == (ml,), f"batch row {i}: shapes")
        for k in ("mel", "mel_noisy", "wav", "wav_noisy", "f0", "energy"):
            check(bool(np.isfinite(r[k]).all()), f"batch row {i}: non-finite {k}")

    def rounded(x):
        return sm.duration_rounded(torch.from_numpy(x).to(synth.device), 1.0).cpu().numpy()

    # every row against its request alone (hold_request), its clean and
    # its noisy outputs
    records = []
    for i, (r, (s, rf, sp), row_ids) in enumerate(zip(res, rows, ids)):
        single = synth.synthesize(s, rf, sp)
        L = len(row_ids)
        d = (rounded(log_d[i, :L]), rounded(single["duration"][:L]))
        rec = hold_request(np, frontend, bins, f"batch row {i}", {**r, "log_d": log_d[i, :L]},
                           {**single, "log_d": single["duration"][:L]}, durations=d)
        noisy = hold_request(np, frontend, bins, f"batch row {i} noisy",
                             {**r, "mel": r["mel_noisy"], "wav": r["wav_noisy"]},
                             {**single, "mel": single["mel_noisy"], "wav": single["wav_noisy"]})
        records.append({"row": i, "clean": rec, "noisy": noisy})
    held = sum(rec[k]["held"] for rec in records for k in ("clean", "noisy"))
    check(held >= len(records), f"batch: {held} of {2 * len(records)} mels held, fewer than half")
    audio_s = sum(r["mel_len"] for r in res) * cfg.hop_length / cfg.sampling_rate
    emit("batch", rows=len(res), buckets=own.pop(), wall_ms=wall_ms, audio_s=audio_s,
         audio_s_per_wall_s=audio_s / (wall_ms / 1e3), mel_lens=[r["mel_len"] for r in res],
         mels_held=held, mels=2 * len(records), rows_vs_synthesize=records,
         tolerance="log-d, f0, energy within 1e-4 x max(1, max|request|); mel within "
                   "2e-4 + 1e-4 x |request|; wav log-mel MAE < 0.1",
         kernels_held=kernels_held, launches=launches, card=smi)

    # profile_batch: the same call under torch.profiler
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        synth.synthesize_batch(sentences, refs, spks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prows, host = profile_rows(torch, prof)
    emit_profile("profile_batch", prows, host, wall_ms, batch_rows=len(rows), card=smi)

    # long: a sentence of 300-400 phonemes, two chunks of the 256 bucket
    long_sentence = " ".join([SENTENCES[2]] * 3)
    n_ph = len(synth.text_to_ids(long_sentence))
    check(cfg.src_buckets[-1] < n_ph <= 400, f"long: {n_ph} phonemes")
    with Capture(synth) as cap:
        synth.synthesize(long_sentence, ref, spk)
        torch.cuda.synchronize()
    kernels_held = hold_kernels(torch, "long", cap)
    check(len(cap.forwards) == 1, f"long: {len(cap.forwards)} forwards, expected one chunk batch")
    chunk_lens = cap.forwards[0][2][0].mel_len.tolist()
    del cap
    n.reset()
    t0 = time.perf_counter()
    out = synth.synthesize(long_sentence, ref, spk)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = n.check_serving("long", per_vocode, per_encode)
    k = out.get("chunks")
    ml = out["mel_len"]
    check(k == 2 and len(chunk_lens) == 2, f"long: {k} chunks in a batch of {len(chunk_lens)}, expected 2")
    check(ml == sum(chunk_lens) and out["mel"].shape == (ml, cfg.n_mel_channels)
          and out["wav"].shape == (ml * cfg.hop_length,), "long: lengths and shapes")
    for key in ("mel", "mel_noisy", "wav", "wav_noisy", "f0", "energy"):
        check(bool(np.isfinite(out[key]).all()), f"long: non-finite {key}")
    emit("long", phonemes=n_ph, chunks=k, chunk_mel_lens=chunk_lens, mel_len=ml,
         wall_ms=wall_ms, kernels_held=kernels_held, launches=launches, card=smi)

    # inspect: the ten-row ablation grid of one sentence
    sentence = SENTENCES[-1]
    single = synth.synthesize(sentence, ref, spk)
    with Capture(synth) as cap:
        synth.inspect(sentence, ref, spk)
        torch.cuda.synchronize()
    kernels_held = hold_kernels(torch, "inspect", cap)
    del cap
    n.reset()
    t0 = time.perf_counter()
    grid = synth.inspect(sentence, ref, spk)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = n.check_serving("inspect", per_vocode, per_encode)
    titles = ["T+D+P+E+S+N", "T+D+P+E+N", "T+D+P+N", "T+D+N", "T+N",
              "T", "T+D", "T+D+P", "T+D+P+E", "T+D+P+E+S"]
    check(list(grid) == titles, f"inspect: titles {list(grid)}")
    for title, g in grid.items():
        check(all(bool(np.isfinite(g[key]).all()) for key in ("mel", "wav", "f0", "energy"))
              and g["wav"].shape == (g["mel_len"] * cfg.hop_length,), f"inspect {title}: non-finite or shape")
    raw = uncast(synth, lambda: synth.inspect(sentence, ref, spk))
    ident = {}
    for title, sfx in (("T+D+P+E+S", ""), ("T+D+P+E+S+N", "_noisy")):
        ident[title] = hold_f16(np, frontend, bins, f"inspect {title}", grid[title], raw[title],
                                {**single, "mel": single["mel" + sfx], "wav": single["wav" + sfx]})
    emit("inspect", sentence=sentence, rows=len(grid), wall_ms=wall_ms, identities=ident,
         mel_lens=[g["mel_len"] for g in grid.values()], kernels_held=kernels_held,
         launches=launches, card=smi)

    # mix: two sentences x the two references, 32 combinations
    pair = (SENTENCES[0], SENTENCES[1])
    singles = {c: synth.synthesize(pair[i], (ref, ref2)[i], (spk, spk2)[i])
               for c, i in (("00000", 0), ("11111", 1))}
    with Capture(synth) as cap:
        synth.mix_and_match(pair, (ref, ref2), (spk, spk2))
        torch.cuda.synchronize()
    kernels_held = hold_kernels(torch, "mix", cap)
    del cap
    n.reset()
    t0 = time.perf_counter()
    mix = synth.mix_and_match(pair, (ref, ref2), (spk, spk2))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = n.check_serving("mix", per_vocode, per_encode)
    check(list(mix) == [f"{c:05b}" for c in range(32)], "mix: titles")
    for title, g in mix.items():
        check(all(bool(np.isfinite(g[key]).all()) for key in ("mel", "wav", "f0", "energy"))
              and g["wav"].shape == (g["mel_len"] * cfg.hop_length,), f"mix {title}: non-finite or shape")
    raw = uncast(synth, lambda: synth.mix_and_match(pair, (ref, ref2), (spk, spk2)))
    ident = {title: hold_f16(np, frontend, bins, f"mix {title}", mix[title], raw[title], single)
             for title, single in singles.items()}
    emit("mix", sentences=list(pair), rows=len(mix), wall_ms=wall_ms,
         M_comb=bucket_for(max(g["mel_len"] for g in mix.values()), cfg.mel_buckets),
         identities=ident, kernels_held=kernels_held, launches=launches, card=smi)

    # residual_off: the acoustic forward at B = 1, (src, mel) buckets (128, 1024)
    ids = synth.text_to_ids(SENTENCES[-1])
    check(bucket_for(len(ids), cfg.src_buckets) == 128, "residual_off: not the 128 src bucket")
    src_seq, src_len, mel, f0, en, mel_len, sp = synth._pack_rows([ids], [ref], [spk])
    pad = M - mel.shape[1]
    mel, f0, en = F.pad(mel, (0, 0, 0, pad)), F.pad(f0, (0, pad)), F.pad(en, (0, pad))
    times, busy, outs = {}, {}, {}
    n.reset()
    with torch.no_grad():
        for residual in (False, True):
            def fwd():
                return synth.model(src_seq, mel, mel, f0, en, src_len, mel_len, M, sp,
                                   residual=residual)
            outs[residual] = fwd()
            times[residual] = cuda_ms(torch, fwd, 5)
            # an eager forward at B = 1 leaves the card idle between
            # operators, so the events read the host's pace; the profile's
            # kernel rows give the device's own time
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                fwd()
                torch.cuda.synchronize()
            busy[residual] = sum(r[2] for r in profile_rows(torch, prof)[0])
    launches = n.check_serving("residual_off", 0, 2 * 8 * per_encode)
    a, b = outs[False].mel_postnet, outs[True].mel_postnet
    err = (a - b).abs().max().item()
    check(outs[False].mel_postnet_noisy is a and torch.equal(outs[False].mel_len, outs[True].mel_len)
          and bool(((a - b).abs() <= 2e-4 + 1e-4 * b.abs()).all()),
          f"residual_off: clean mel off the residual forward's by {err}")
    emit("residual_off", shape={"B": 1, "L": 128, "M": M}, ms_residual_off=times[False],
         ms_residual_on=times[True], device_busy_ms_residual_off=busy[False],
         device_busy_ms_residual_on=busy[True], max_abs_err=err, tolerance="2e-4 + 1e-4 x |on|",
         launches=launches, card=smi)


# the reference directory of phases reference, serve and serve_cli: val_0000
# under a VCTK-style name, trimmed by a TextGrid with silence at both ends
# (the wav is 3.065 s), and val_0001 under a second name whose speaker has a
# precomputed embedding
REF_TRIMMED, REF_NPY = "p901_001", "p902_001"
REF_GRID = [(0.0, 0.35, "sil"), (0.35, 0.9, "HH"), (0.9, 1.1, "sp"), (1.1, 2.7, "AY1"),
            (2.7, 3.06, "sil")]


def write_reference_dir(np, root: str) -> dict:
    """The reference directory under ``root``; returns the config
    overrides that point at it."""
    from styler_tpu_torch.data.textgrid import format_textgrid

    refs = os.path.join(root, "refs")
    spk_dir = os.path.join(root, "preprocessed", "VCTK", "spker_embed")
    os.makedirs(refs)
    os.makedirs(spk_dir)
    val = os.path.join(ROOT, "assets", "vocoder", "val")
    shutil.copy(os.path.join(val, "val_0000.wav"), os.path.join(refs, REF_TRIMMED + ".wav"))
    with open(os.path.join(refs, REF_TRIMMED + ".TextGrid"), "w") as f:
        f.write(format_textgrid(REF_GRID))
    shutil.copy(os.path.join(val, "val_0001.wav"), os.path.join(refs, REF_NPY + ".wav"))
    e = np.random.default_rng(2).standard_normal((1, 512)).astype(np.float32)
    np.save(os.path.join(spk_dir, f"VCTK-spker_embed-{REF_NPY.split('_')[0]}.npy"), e / np.linalg.norm(e))
    return {"ref_audio_dir": refs, "ref_tg_dir": refs,
            "preprocessed_basedir": os.path.join(root, "preprocessed")}


def encoder_flops(torch, model, x) -> float:
    """Multiply-adds x 2 of the encoder's convolutions and affine on ``x``,
    counted from the shapes by forward hooks."""
    nn = torch.nn
    total = []

    def hook(m, inp, out):
        if isinstance(m, nn.Conv2d):
            total.append(2.0 * out.numel() * m.in_channels * m.kernel_size[0] * m.kernel_size[1])
        else:
            total.append(2.0 * out.numel() * m.in_features)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return sum(total)


def phase_speaker(torch, cfg, smi):
    """The trained speaker encoder (``SpeakerEmbedder(cfg, backend="native")``)
    on the card against the CPU on the four validation wavs, the fallback
    tier on both, and the times of one embedding: the host features and the
    device forward apart. Returns the card's embedder.

    The card-vs-CPU limit sits between the f32 forward's gap (4.5e-8 on
    an H100 80GB HBM3 at 700 W) and that of a control forward with TF32
    convolutions and matmuls (6.8e-6 there), which the phase measures too
    and requires above the limit."""
    import numpy as np

    from styler_tpu_torch.data.audio_io import read_wav
    from styler_tpu_torch.data.vctk import SpeakerEmbedder
    from styler_tpu_torch.speaker import speaker_features_from_audio

    card = SpeakerEmbedder(cfg, backend="native")
    cpu = SpeakerEmbedder(cfg, backend="native", device="cpu")
    check(next(card.model.parameters()).is_cuda, "speaker: the encoder is not on the card")
    val = os.path.join(ROOT, "assets", "vocoder", "val")
    audios = [read_wav(os.path.join(val, f"val_000{i}.wav"))[0] for i in range(4)]
    card.embed_wav(audios[0])  # untimed: the first cuDNN calls
    tol = 1e-6
    embs, per_wav, cpu_embs = [], [], []
    for i, a in enumerate(audios):
        g, c = card.embed_wav(a), cpu.embed_wav(a)
        norm = float(np.linalg.norm(g))
        err = float(np.abs(g - c).max())
        check(g.shape == (1, cfg.speaker_embed_dim) and bool(np.isfinite(g).all()) and abs(norm - 1) < 1e-4,
              f"speaker val_000{i}: shape {g.shape}, norm {norm}")
        check(err <= tol, f"speaker val_000{i}: card vs cpu {err} > {tol}")
        embs.append(g[0])
        cpu_embs.append(c)
        per_wav.append({"wav": f"val_000{i}", "norm": norm, "max_abs_err_vs_cpu": err})
    # the control: the same forwards with TF32 allowed, then the f32 setting back
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        card.embed_wav(audios[0])  # the TF32 algorithms' first calls
        tf32_err = max(float(np.abs(card.embed_wav(a) - c).max()) for a, c in zip(audios, cpu_embs))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    check(tf32_err > tol, f"speaker: a TF32 forward is within {tol} of the CPU ({tf32_err}), "
                          "so the limit cannot tell it from f32")
    cos = np.stack(embs) @ np.stack(embs).T
    min_dist = float(1.0 - cos[np.triu_indices(4, 1)].max())
    check(min_dist > 1e-3, f"speaker: two val wavs embed alike (cosine distance {min_dist})")

    fallback = [SpeakerEmbedder(cfg, backend="fallback", device=d) for d in (None, "cpu")]
    check(all(np.array_equal(fallback[0].embed_wav(a), fallback[1].embed_wav(a)) for a in audios),
          "speaker: the fallback tier differs between the card's embedder and the CPU's")

    feat_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        feats = speaker_features_from_audio(audios[0], cfg.sampling_rate, cfg.win_length)
        feat_ms.append((time.perf_counter() - t0) * 1e3)
    x = torch.from_numpy(feats).permute(2, 0, 1)[None].cuda()
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, lambda: card.model(x), 20)
    wall_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        card.embed_wav(audios[0])
        wall_ms.append((time.perf_counter() - t0) * 1e3)
    flops = encoder_flops(torch, card.model, x)
    n_bytes = 4.0 * (x.numel() + sum(p.numel() for p in card.model.parameters()) + cfg.speaker_embed_dim)
    bound_ms, bound_by = bound(flops, PEAK_F32, n_bytes)
    emit("speaker", backend="native", input=list(x.shape), per_wav=per_wav,
         min_pairwise_cosine_distance=min_dist, tf32_control_max_abs_err_vs_cpu=tf32_err,
         tolerance=f"card vs cpu {tol} per entry (TF32 control above it); norm 1 +- 1e-4",
         fallback_equal=True, features_ms=feat_ms, forward_ms=fwd_ms, embed_wav_wall_ms=wall_ms,
         gflop=flops / 1e9, bound_ms=bound_ms, bound_by=bound_by, card=smi)
    return card


def phase_reference(synth, cfg_ref, embedder, smi):
    """``load_reference`` from a reference directory: the TextGrid trim
    (mel_len = the durations' sum), the npy embedding where one exists, the
    encoder's embedding of the trimmed wav where not; ms for a new
    reference, with its f0, mel and speaker parts timed apart."""
    import numpy as np

    from styler_tpu_torch.data.audio_io import read_wav_int
    from styler_tpu_torch.data.textgrid import alignment_from_file
    from styler_tpu_torch.data.vctk import SpeakerEmbedder
    from styler_tpu_torch.dsp.pitch import get_f0
    from styler_tpu_torch.synthesis import load_reference

    refs = cfg_ref.ref_audio_dir
    ref_npy, spk_npy = load_reference(cfg_ref, synth.frontend, REF_NPY)
    want = np.load(os.path.join(cfg_ref.preprocessed_path, "spker_embed", "VCTK-spker_embed-p902.npy"))
    check(np.array_equal(spk_npy, want), f"reference {REF_NPY}: not the precomputed embedding")
    sr, whole = read_wav_int(os.path.join(refs, REF_NPY + ".wav"))
    check(ref_npy.mel_len == len(whole) // cfg_ref.hop_length + 1,
          f"reference {REF_NPY}: mel_len {ref_npy.mel_len} for {len(whole)} samples untrimmed")

    t0 = time.perf_counter()
    ref, spk = load_reference(cfg_ref, synth.frontend, REF_TRIMMED)
    total_ms = (time.perf_counter() - t0) * 1e3
    _, durations, start, end = alignment_from_file(
        os.path.join(refs, REF_TRIMMED + ".TextGrid"), cfg_ref.sampling_rate, cfg_ref.hop_length)
    sr, wav = read_wav_int(os.path.join(refs, REF_TRIMMED + ".wav"))
    trimmed = wav[int(sr * start): int(sr * end)].astype(np.float32)
    check(ref.mel_len == sum(durations) and ref.mel.shape == (sum(durations), cfg_ref.n_mel_channels),
          f"reference {REF_TRIMMED}: mel_len {ref.mel_len}, durations sum {sum(durations)}")
    for key in ("mel", "f0_norm", "energy01"):
        check(bool(np.isfinite(getattr(ref, key)).all()), f"reference: non-finite {key}")
    direct = embedder.embed_wav(trimmed / cfg_ref.max_wav_value)
    err = float(np.abs(spk - direct).max())
    check(err <= 1e-6, f"reference {REF_TRIMMED}: embedding off embed_wav of the trimmed wav by {err}")

    parts = {"f0_ms": [], "mel_ms": [], "speaker_load_ms": [], "speaker_embed_ms": []}
    for _ in range(3):
        t0 = time.perf_counter()
        get_f0(trimmed, cfg_ref, durations)
        t1 = time.perf_counter()
        synth.frontend(trimmed / cfg_ref.max_wav_value)
        t2 = time.perf_counter()
        emb = SpeakerEmbedder(cfg_ref, device=synth.frontend.device)
        t3 = time.perf_counter()
        emb.embed_wav(trimmed / cfg_ref.max_wav_value)
        t4 = time.perf_counter()
        for key, (a, b) in zip(parts, ((t0, t1), (t1, t2), (t2, t3), (t3, t4))):
            parts[key].append((b - a) * 1e3)
    emit("reference", name=REF_TRIMMED, seconds_in=len(wav) / sr, trim_s=[start, end],
         mel_len=ref.mel_len, durations_sum=int(sum(durations)), embedding_vs_embed_wav=err,
         npy_reference=REF_NPY, npy_mel_len=ref_npy.mel_len, new_reference_ms=total_ms, **parts,
         card=smi)


SERVE_SYNTHESIZING = {1, 3, 5, 8}  # the requests that run one forward and one vocoder call


def serve_requests(outdir: str) -> list:
    """The request list of ``tests/test_cli.py:203-222`` on the trimmed
    reference."""
    R = REF_TRIMMED
    return [
        {"id": 0, "cmd": "ping"},
        {"id": 1, "sentence": "Hi.", "ref": R},
        {"id": 2, "sentence": "Hi again.", "ref": "missing_ref"},
        {"id": 3, "sentence": "Hi.", "ref": R, "out": os.path.join(outdir, "custom.flac")},
        {"id": 5, "sentences": ["One two.", "Three."], "ref": R},
        {"id": 6, "sentences": [], "ref": R},
        {"id": 7, "sentences": ["Hi."], "refs": [], "ref": R},
        {"id": 8, "ref": R, "sentence": "The quick brown fox jumps over the lazy dog, " * 4},
        {"id": 9, "ref": R},
        {"id": 4, "cmd": "shutdown"},
    ]


def check_serve_replies(cfg_ref, by_id: dict, what: str) -> None:
    """The replies to ``serve_requests`` as ``tests/test_cli.py`` checks
    them: wav files of mel_len x 256 samples, the errors' contract."""
    from scipy.io import wavfile

    from styler_tpu_torch.cli.serve import CONTRACT

    def wav_len(path, mel_len):
        sr, data = wavfile.read(path)
        check(sr == cfg_ref.sampling_rate and len(data) == mel_len * cfg_ref.hop_length > 0,
              f"{what}: {path} holds {len(data)} samples at {sr} Hz for mel_len {mel_len}")

    check(by_id[0] == {"id": 0, "ok": True, "pong": True} and by_id[4] == {"id": 4, "ok": True, "bye": True},
          f"{what}: ping / shutdown")
    for rid in (1, 3, 8):
        check(by_id[rid]["ok"], f"{what} request {rid}: {by_id[rid]}")
        wav_len(by_id[rid]["wav"], by_id[rid]["mel_len"])
        wav_len(by_id[rid]["wav_noisy"], by_id[rid]["mel_len"])
    check(by_id[3]["wav"].endswith("custom.flac.wav") and by_id[3]["wav_noisy"].endswith("custom.flac_noisy.wav"),
          f"{what}: out path {by_id[3]}")
    check(not by_id[2]["ok"] and "error" in by_id[2], f"{what}: missing reference {by_id[2]}")
    check(by_id[5]["ok"] and len(by_id[5]["wavs"]) == 2 == len(by_id[5]["mel_lens"])
          and "truncated" not in by_id[5], f"{what}: batch {by_id[5]}")
    for w, wn, ml in zip(by_id[5]["wavs"], by_id[5]["wavs_noisy"], by_id[5]["mel_lens"]):
        wav_len(w, ml)
        wav_len(wn, ml)
    check(not by_id[6]["ok"] and "empty" in by_id[6]["error"], f"{what}: empty batch {by_id[6]}")
    check(not by_id[7]["ok"] and "must match" in by_id[7]["error"], f"{what}: mismatched batch {by_id[7]}")
    check(by_id[9] == {"id": 9, "ok": False, "error": CONTRACT}, f"{what}: unknown shape {by_id[9]}")


def file_vs_synthesize(np, synth, path, ref, spk, what) -> float:
    """The log-mel MAE of a wav file the server wrote for "Hi." against
    ``synth.synthesize`` in-process, both through the 16-bit quantisation
    audiowrite applies; fails at 0.1."""
    from scipy.io import wavfile

    want = synth.synthesize("Hi.", ref, spk)
    sr, got = wavfile.read(path)
    want16 = (np.clip(want["wav"], -1, 1) * 32767).astype(np.int16)
    check(len(got) == len(want16), f"{what}: the file's length differs from synthesize()'s")
    mae = float(np.abs(synth.frontend(got / 32767.0)[0] - synth.frontend(want16 / 32767.0)[0]).mean())
    check(mae < 0.1, f"{what}: the file's log-mel MAE against synthesize() {mae}")
    return mae


def phase_serve(torch, synth, cfg_ref, smi, outdir):
    """The server's request handler (``cli/serve.py:Server``) on the
    iSTFTNet synthesizer with the reference directory: the request list of
    ``tests/test_cli.py:203-222`` once under ``Capture`` (every call of
    kernels A and B held against its plain version), then again with the
    launches of each request counted and each reply checked as that test
    does; the single request's wav file against ``synthesize`` in-process;
    the ms of a request on a cached reference."""
    import numpy as np

    from styler_tpu_torch.cli.serve import Server

    R = REF_TRIMMED
    reqs = serve_requests(outdir)
    server = Server(synth, cfg_ref, outdir)
    with Capture(synth) as cap:
        for req in reqs:
            server.handle(req)
        torch.cuda.synchronize()
    kernels_held = hold_kernels(torch, "serve", cap)
    check(len(cap.forwards) == len(SERVE_SYNTHESIZING), f"serve: {len(cap.forwards)} forwards")
    del cap

    n = Launches()
    by_id, launches, ms = {}, {}, {}
    for req in reqs:
        n.reset()
        t0 = time.perf_counter()
        rep = server.handle(req)
        torch.cuda.synchronize()
        ms[req["id"]] = (time.perf_counter() - t0) * 1e3
        k = req["id"] in SERVE_SYNTHESIZING
        launches[req["id"]] = n.check_serving(f"serve request {req['id']}", 36 * k, 2 * k)
        json.dumps(rep)
        by_id[req["id"]] = rep
    check_serve_replies(cfg_ref, by_id, "serve")

    # the single request's file against synthesize() in-process, both
    # through the 16-bit quantisation audiowrite applies
    ref, spk = server.ref_cache[(R, None, False)]
    mae = file_vs_synthesize(np, synth, by_id[1]["wav"], ref, spk, "serve")

    # a request on a cached reference: one untimed, three timed
    timed = {"sentence": SENTENCES[1], "ref": R}
    server.handle(timed)
    walls, replies_ms = [], []
    for _ in range(3):
        n.reset()
        t0 = time.perf_counter()
        rep = server.handle(timed)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        replies_ms.append(rep["ms"])
        n.check_serving("serve timed request", 36, 2)
        check(rep["ok"], f"serve timed request: {rep}")
    emit("serve", requests=len(reqs), request_ms=ms, launches=launches, wav_vs_synthesize_log_mel_mae=mae,
         cached_request_wall_ms=walls, cached_request_reply_ms=replies_ms, sentence=SENTENCES[1],
         mel_len=rep["mel_len"], references_cached=len(server.ref_cache), kernels_held=kernels_held,
         card=smi)


def run_server_child(argv, workdir, what):
    """``python -m styler_tpu_torch.cli.serve *argv`` as a child process on
    the card (it inherits ``STYLER_TORCH_BUILD_DIR``): ping, one request on
    the trimmed reference, shutdown. Checks the exit code, that every
    stdout line is a JSON reply, the wav's length and that the child built
    no kernel. Returns (replies, seconds to each reply, seconds to the
    exit, the child's stderr)."""
    from scipy.io import wavfile

    from styler_tpu_torch.ops import build

    libs_before = sorted(os.listdir(build.build_dir()))
    reqs = [{"id": 0, "cmd": "ping"}, {"id": 1, "sentence": SENTENCES[1], "ref": REF_TRIMMED},
            {"id": 2, "cmd": "shutdown"}]
    err_path = os.path.join(workdir, f"{what}.stderr")
    t0 = time.perf_counter()
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "styler_tpu_torch.cli.serve", *argv],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=err, text=True)
        try:
            proc.stdin.write("".join(json.dumps(r) + "\n" for r in reqs))
            proc.stdin.close()
            lines, at = [], []
            for line in proc.stdout:
                lines.append(line)
                at.append(time.perf_counter() - t0)
            rc = proc.wait(timeout=300)
            exit_s = time.perf_counter() - t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(err_path) as f:
        stderr = f.read()
    check(rc == 0, f"{what}: exit code {rc}: {stderr[-2000:]}")
    replies = []
    for line in lines:
        try:
            replies.append(json.loads(line))
        except json.JSONDecodeError:
            raise RuntimeError(f"{what}: a stdout line is not JSON: {line!r}") from None
    check([r.get("id") for r in replies] == [0, 1, 2] and replies[0].get("pong") and replies[2].get("bye")
          and replies[1].get("ok"), f"{what}: replies {replies}")
    sr, data = wavfile.read(os.path.join(ROOT, replies[1]["wav"]))
    check(len(data) == replies[1]["mel_len"] * 256 > 0, f"{what}: wav of {len(data)} samples")
    check(sorted(os.listdir(build.build_dir())) == libs_before, f"{what}: the child built kernels")
    return replies, at, exit_s, stderr


def phase_serve_cli(np, cfg_ref, smi, workdir):
    """``python -m styler_tpu_torch.cli.serve`` as a child process on the card
    (it inherits ``STYLER_TORCH_BUILD_DIR``, so it builds nothing): ping,
    one request, shutdown; then ``python -m styler_tpu_torch.cli.synthesize``
    once."""
    from scipy.io import wavfile

    from styler_tpu_torch.ops import build

    libs_before = sorted(os.listdir(build.build_dir()))
    refs = cfg_ref.ref_audio_dir
    replies, at, serve_s, _ = run_server_child(
        ["--ref_audio_dir", refs, "--ref_tg_dir", refs, "--outdir", os.path.join(workdir, "serve_cli")],
        workdir, "serve_cli")

    out2 = os.path.join(workdir, "synthesize_cli")
    t1 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "styler_tpu_torch.cli.synthesize", "--ref_name", REF_TRIMMED,
         "--ref_audio_dir", refs, "--ref_tg_dir", refs, "--sentence", SENTENCES[1], "--outdir", out2],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    synth_s = time.perf_counter() - t1
    check(proc.returncode == 0, f"synthesize_cli: exit code {proc.returncode}: {proc.stderr[-2000:]}")
    stem = os.path.join(out2, f"0_iSTFTNet_{SENTENCES[1][:10].replace(' ', '_')}")
    mel = np.load(stem + "_mel.npy")
    for path in (stem + ".wav", stem + "_noisy.wav"):
        sr, data = wavfile.read(path)
        check(len(data) == mel.shape[0] * 256 > 0 and bool(np.isfinite(data).all()), f"synthesize_cli: {path}")
    check(mel.shape[1] == 80 and bool(np.isfinite(mel).all()), "synthesize_cli: mel npy")
    check(sorted(os.listdir(build.build_dir())) == libs_before, "synthesize_cli: the child built kernels")
    emit("serve_cli", first_reply_s=at[0], request_reply_s=at[1], request_ms=replies[1]["ms"],
         exit_s=serve_s, mel_len=replies[1]["mel_len"],
         synthesize_cli_s=synth_s, synthesize_cli_mel_len=int(mel.shape[0]), card=smi)


def sync_count(torch, fn):
    """(fn(), the synchronising CUDA operations it ran): warnings of
    ``torch.cuda.set_sync_debug_mode("warn")``, one per synchronisation."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def bundle_vs_live(np, synth, what, got, want) -> dict:
    """A bundle's result (a graph replay) against the live eager result of
    the same request: which keys are bit-equal, and ``hold_request``'s
    tolerances (those of the serve phase's file check and the batch rows)
    on everything that is not."""
    keys = ("mel", "mel_noisy", "wav", "wav_noisy", "f0", "energy")
    check(got["mel_len"] == want["mel_len"], f"{what}: mel_len {got['mel_len']}, live {want['mel_len']}")
    differs = [k for k in keys if not np.array_equal(got[k], want[k])]
    rec = {"mel_len": got["mel_len"], "bit_equal": not differs}
    if differs:
        sm = synth.model.style_modeling
        bins = (sm.pitch_bins.cpu().numpy(), sm.energy_bins.cpu().numpy())
        rec["differs"] = {k: float(np.abs(got[k] - want[k]).max()) for k in differs}
        rec["held"] = hold_request(np, synth.frontend, bins, what, got, want)
    return rec


def phase_bundle(torch, synth, cfg, ref, spk, smi, workdir):
    """The serving bundle (``core/export.py``) of the iSTFTNet synthesizer:
    exported at the default buckets (5 x 5) for batches 1 and 8, loaded
    through ``BundleSynthesizer`` and warmed (every entry captured as a
    CUDA graph after one eager forward, then replayed once); the capture
    seconds, graph count and the memory the pool holds; ``main``'s requests
    and one 8-row batch against the live eager ``synthesize`` /
    ``synthesize_batch`` (bit-equal expected, else named and held);
    kernels A and B held against their plain versions on the calls
    recorded while an entry was captured, read back after a replay of a
    real request; A's and B's kernels in a profiler trace of one replay;
    synchronisations per call; request wall and device idle share, graph
    against eager. Returns the BundleSynthesizer and its directory."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from styler_tpu_torch.core.config import bucket_for
    from styler_tpu_torch.core.export import BundleSynthesizer, save_serving_bundle

    out = os.path.join(workdir, "bundle_istft")
    t0 = time.perf_counter()
    manifest = save_serving_bundle(synth, out, batch=(1, 8))
    export_s = time.perf_counter() - t0
    n_entries = 2 * len(cfg.src_buckets) * len(cfg.mel_buckets)
    check(len(manifest["entries"]) == n_entries == 50, f"bundle: {len(manifest['entries'])} entries")
    t0 = time.perf_counter()
    bs = BundleSynthesizer(out, cfg)
    bundle = bs.bundle
    load_s = time.perf_counter() - t0
    check(bundle.device.type == "cuda" and bundle.mel_out == cfg.mel_buckets[-1], "bundle: not on the card")

    n = Launches()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = (torch.cuda.memory_reserved(), torch.cuda.memory_allocated())
    n.reset()
    t0 = time.perf_counter()
    count = bs.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = n.read()
    mem1 = (torch.cuda.memory_reserved(), torch.cuda.memory_allocated())
    torch.cuda.empty_cache()  # what stays reserved is the graphs' pool and the static buffers
    mem2 = (torch.cuda.memory_reserved(), torch.cuda.memory_allocated())
    check(count == n_entries == len(bundle._graphs), f"bundle: warmup {count}, graphs {len(bundle._graphs)}")
    # per entry one eager forward and one capture, 36 launches of A and 2
    # of B each; the replays launch nothing through the wrappers
    check(launches["resblock_stage"] == 72 * count and launches["lstm_recurrence"] == 4 * count
          and launches["resblock_stage_int8"] == launches["lstm_backward"] == 0,
          f"bundle warmup: launches {launches}")
    gib = 2.0 ** 30
    emit("bundle_capture", export_s=export_s, load_s=load_s, warmup_s=warm_s, graphs=len(bundle._graphs),
         per_graph_s=warm_s / count, launches_at_capture=launches,
         reserved_gib_before=mem0[0] / gib, reserved_gib_after=mem1[0] / gib,
         reserved_gib_after_empty_cache=mem2[0] / gib, allocated_gib_before=mem0[1] / gib,
         allocated_gib_after=mem2[1] / gib, pool_gib=(mem2[0] - mem0[0]) / gib, card=smi)

    # main's requests and one 8-row batch: graph against live eager
    n.reset()
    main = []
    for s in SENTENCES:
        got, want = bs.synthesize(s, ref, spk), synth.synthesize(s, ref, spk)
        main.append({"sentence": s[:40], **bundle_vs_live(np, synth, f"bundle {s[:20]}", got, want)})
    got = bs.synthesize_batch(list(BATCH_SENTENCES), [ref] * 8, [spk] * 8)
    want = synth.synthesize_batch(list(BATCH_SENTENCES), [ref] * 8, [spk] * 8)
    batch = [bundle_vs_live(np, synth, f"bundle batch row {i}", g, w) for i, (g, w) in enumerate(zip(got, want))]
    replay_launches = n.read()
    check(replay_launches["resblock_stage"] == 36 * (len(SENTENCES) + 1)
          and replay_launches["lstm_recurrence"] == 2 * (len(SENTENCES) + 1),
          f"bundle: launches {replay_launches} in the comparison (only the live side's expected)")

    # kernels A and B on the calls recorded while an entry was captured:
    # the recorded tensors live in the graph's pool and hold the values of
    # the replay that follows (nothing else writes them while they live)
    ids = bs.text_to_ids(SENTENCES[1])
    key = (1, bundle._bucket(1, len(ids)), bundle._bucket(2, ref.mel_len))
    check(key[1] == bucket_for(len(ids), cfg.src_buckets), "bundle: src bucket")
    del bundle._graphs[key]
    with Capture(bundle.synth) as cap:
        bundle.graph(key)
    # per forward 2 stage calls of A and 2 layer calls of B: the eager
    # forward's calls, then the capture's
    for name, calls in cap.calls.items():
        check(len(calls) == 4,
              f"bundle: {len(calls)} recorded calls of {name}")
        cap.calls[name] = calls[len(calls) // 2:]
    got = bs.synthesize(SENTENCES[1], ref, spk)
    torch.cuda.synchronize()
    ns = got["mel_len"] * cfg.hop_length
    check(np.array_equal(cap.forwards[1][2][1][0, :ns].cpu().numpy(), got["wav"]),
          "bundle: the recorded graph output is not the replay's")
    kernels_held = hold_kernels(torch, "bundle", cap)
    del cap

    # one replay under the profiler: A's and B's kernels in its trace
    def profiled(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows, host = profile_rows(torch, prof)
        busy = sum(r[2] for r in rows)
        return {"wall_ms": wall, "device_busy_ms": busy, "device_idle_share": 1 - busy / wall,
                "host_ops": sum(r[1] for r in host),
                "kernel_a": sum(c for k, c, _ in rows if "resblock_" in k),
                "kernel_b": sum(c for k, c, _ in rows if "lstm_" in k),
                "top": [{"kernel": k[:90], "count": c, "ms": ms} for k, c, ms in rows[:8]]}

    s = SENTENCES[-1]
    graph_prof = profiled(lambda: bs.synthesize(s, ref, spk))
    eager_prof = profiled(lambda: synth.synthesize(s, ref, spk))
    emit("bundle_profile", graph=graph_prof, eager=eager_prof, sentence=s[:40])
    check(graph_prof["kernel_a"] == 36 and graph_prof["kernel_b"] == 2,
          f"bundle: the replay's trace holds {graph_prof['kernel_a']} launches of A and "
          f"{graph_prof['kernel_b']} of B (36 and 2 expected)")

    # synchronisations per call, and wall times in turns
    _, syncs_graph = sync_count(torch, lambda: bs.synthesize(s, ref, spk))
    _, syncs_eager = sync_count(torch, lambda: synth.synthesize(s, ref, spk))
    zeros = [np.full(sh, fill, np.float32) for sh, _, fill in bundle._specs((1, 128, 512))]
    _, syncs_call = sync_count(torch, lambda: bundle._run((1, 128, 512), zeros[:7] + [1.0, 1.0, 1.0]))
    check(syncs_call == 1, f"bundle: {syncs_call} synchronisations in one call")
    walls = {"eager": [], "graph": []}
    for order in (("eager", "graph"), ("graph", "eager"), ("eager", "graph"), ("graph", "eager")):
        for which in order:
            fn = synth.synthesize if which == "eager" else bs.synthesize
            t0 = time.perf_counter()
            fn(s, ref, spk)
            torch.cuda.synchronize()
            walls[which].append((time.perf_counter() - t0) * 1e3)
    emit("bundle", main=main, batch_rows=batch, kernels_held=kernels_held, replay_key=list(key),
         syncs_per_request={"graph": syncs_graph, "eager": syncs_eager},
         syncs_per_call=syncs_call, wall_ms=walls,
         mean_wall_ms={k: sum(v) / len(v) for k, v in walls.items()}, sentence=s[:40], card=smi)
    return bs, out


def phase_bundle_hifigan(torch, synth, cfg, ref, spk, want, workdir, what):
    """One entry of a HiFi-GAN bundle (bf16, or int8 when ``synth`` runs
    the int8 form) at the bucket of ``SENTENCES[0]``'s request, captured
    and replayed: the launches at capture (one eager forward and the
    capture; none at replay), and the replay against ``want``, the live
    request's result."""
    import numpy as np

    from styler_tpu_torch.core.config import bucket_for
    from styler_tpu_torch.core.export import ServingBundle, save_serving_bundle

    ids = synth.text_to_ids(SENTENCES[0])
    L, M = bucket_for(len(ids), cfg.src_buckets), bucket_for(ref.mel_len, cfg.mel_buckets)
    out = os.path.join(workdir, f"bundle_{what}")
    # the output cap stays the largest bucket, as on the live path
    manifest = save_serving_bundle(synth, out, src_buckets=(L,), mel_buckets=sorted({M, cfg.mel_buckets[-1]}))
    int8 = synth.generator.quantize
    check(manifest["vocoder_form"] == ("int8" if int8 else "bf16"), f"{what}: form {manifest['vocoder_form']}")
    bundle = ServingBundle(out)
    check(bundle.synth.generator.quantize == int8, f"{what}: the bundle's vocoder form")
    n = Launches()
    n.reset()
    t0 = time.perf_counter()
    got = bundle.synthesize(ids, ref.mel[: ref.mel_len], ref.f0_norm[: ref.mel_len],
                            ref.energy01[: ref.mel_len], spk)
    capture_s = time.perf_counter() - t0
    at_capture = n.read()
    a = "resblock_stage_int8" if int8 else "resblock_stage"
    check(at_capture[a] == 2 * 72 and at_capture["lstm_recurrence"] == 4
          and at_capture["resblock_stage_int8_prep"] == (8 if int8 else 0),
          f"{what}: launches at capture {at_capture}")
    n.reset()
    again = bundle.synthesize(ids, ref.mel[: ref.mel_len], ref.f0_norm[: ref.mel_len],
                              ref.energy01[: ref.mel_len], spk)
    check(sum(n.read().values()) == 0 and np.array_equal(again["wav"], got["wav"]), f"{what}: replay")
    rec = bundle_vs_live(np, synth, what, got, want)
    emit(what, entry=[1, L, M], vocoder_form=manifest["vocoder_form"], capture_s=capture_s,
         launches_at_capture=at_capture, **rec)
    del bundle
    shutil.rmtree(out, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_serve_bundle(torch, np, synth, bs, bundle_dir, cfg_ref, smi, workdir):
    """The server's handler over ``BundleSynthesizer`` on ``serve``'s
    request list (every request after the warmup replays a captured graph:
    no kernel launch), the single request's file against the live
    ``synthesize``, three timed requests on a cached reference; then
    ``python -m styler_tpu_torch.cli.serve --bundle DIR --warmup`` as a
    child process that builds no kernel."""
    from styler_tpu_torch.cli.serve import Server

    outdir = os.path.join(workdir, "serve_bundle")
    server = Server(bs, cfg_ref, outdir)
    n = Launches()
    by_id, ms = {}, {}
    for req in serve_requests(outdir):
        n.reset()
        t0 = time.perf_counter()
        rep = server.handle(req)
        torch.cuda.synchronize()
        ms[req["id"]] = (time.perf_counter() - t0) * 1e3
        check(sum(n.read().values()) == 0, f"serve_bundle request {req['id']}: launches {n.read()}")
        json.dumps(rep)
        by_id[req["id"]] = rep
    check_serve_replies(cfg_ref, by_id, "serve_bundle")
    ref, spk = server.ref_cache[(REF_TRIMMED, None, False)]
    mae = file_vs_synthesize(np, synth, by_id[1]["wav"], ref, spk, "serve_bundle")

    timed = {"sentence": SENTENCES[1], "ref": REF_TRIMMED}
    server.handle(timed)
    walls, replies_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        rep = server.handle(timed)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        replies_ms.append(rep["ms"])
        check(rep["ok"], f"serve_bundle timed request: {rep}")

    refs = cfg_ref.ref_audio_dir
    replies, at, exit_s, stderr = run_server_child(
        ["--bundle", bundle_dir, "--warmup", "--ref_audio_dir", refs, "--ref_tg_dir", refs,
         "--outdir", os.path.join(workdir, "serve_bundle_cli")], workdir, "serve_bundle_cli")
    warm = re.search(r"warmup: (\d+) forwards in ([\d.]+)s", stderr)
    check(warm is not None and int(warm.group(1)) == len(bs.bundle._entries),
          f"serve_bundle_cli: no warmup of every entry in its log: {stderr[-1000:]}")
    emit("serve_bundle", request_ms=ms, wav_vs_synthesize_log_mel_mae=mae, cached_request_wall_ms=walls,
         cached_request_reply_ms=replies_ms, sentence=SENTENCES[1], mel_len=rep["mel_len"],
         child_first_reply_s=at[0], child_warmup_s=float(warm.group(2)), child_request_reply_s=at[1],
         child_request_ms=replies[1]["ms"], child_exit_s=exit_s, card=smi)


def phase_hifigan(torch, cfg, mel2b, ref, spk, smi):
    """The HiFi-GAN serving path: kernel A and its int8 form against their
    plain versions on the four stages (hifigan_kernels); 3 requests through
    kernel A (main_hifigan); the same requests through the int8 kernel with
    STYLER_TPU_INT8_VOCODER=1 (int8); one request card vs CPU
    (hifigan_card_vs_cpu). Returns the kernel records and launch counts."""
    import numpy as np

    from styler_tpu_torch.synthesis import load_synthesizer

    per_request = 4 * 18  # 4 stages x 3 branches x 3 dilations x 2 convs

    t0 = time.perf_counter()
    synth = load_synthesizer(cfg, vocoder_arch="HiFi-GAN")
    check(synth.config.vocoder == "HiFi-GAN" and not synth.generator.quantize, "not the HiFi-GAN path")
    emit("load_hifigan", seconds=time.perf_counter() - t0, device=str(synth.device))
    rec_a, rec_q = phase_resblock(torch, synth.generator, mel2b, "HiFi-GAN", int8=True)
    phase_branch_dilations(torch)

    outs, launches = run_requests(torch, synth, ref, spk, cfg, "main_hifigan", smi)
    emit("main_hifigan_launches", **launches)
    workdir = tempfile.mkdtemp(prefix="smoke-bundles-", dir=os.path.join(ROOT, "styler_tpu_torch", "_build"))
    check(launches["resblock_stage"] == per_request * len(SENTENCES)
          and launches["resblock_stage_int8"] == 0,
          f"HiFi-GAN path: kernel A launched {launches['resblock_stage']} times, the int8 kernel "
          f"{launches['resblock_stage_int8']} (expected {per_request} and 0 per request)")
    phase_profile(torch, synth, SENTENCES[-1], ref, spk, "profile_hifigan")
    phase_bundle_hifigan(torch, synth, cfg, ref, spk, outs[0], workdir, "bundle_hifigan")

    os.environ["STYLER_TPU_INT8_VOCODER"] = "1"
    try:
        t0 = time.perf_counter()
        synth_q = load_synthesizer(cfg, vocoder_arch="HiFi-GAN")
    finally:
        del os.environ["STYLER_TPU_INT8_VOCODER"]
    check(synth_q.generator.quantize, "STYLER_TPU_INT8_VOCODER=1 did not select the int8 form")
    emit("load_int8", seconds=time.perf_counter() - t0)
    outs_q, launches_q = run_requests(torch, synth_q, ref, spk, cfg, "int8", smi)
    emit("int8_launches", **launches_q)
    check(launches_q["resblock_stage_int8"] == per_request * len(SENTENCES)
          and launches_q["resblock_stage_int8_prep"] == 4 * len(SENTENCES)
          and launches_q["resblock_stage"] == 0,
          f"int8 path: int8 kernel launched {launches_q['resblock_stage_int8']} times, its prep "
          f"pass {launches_q['resblock_stage_int8_prep']}, kernel A {launches_q['resblock_stage']} "
          f"(expected {per_request}, 4 and 0 per request)")
    phase_profile(torch, synth_q, SENTENCES[-1], ref, spk, "profile_int8")
    phase_bundle_hifigan(torch, synth_q, cfg, ref, spk, outs_q[0], workdir, "bundle_int8")
    shutil.rmtree(workdir, ignore_errors=True)
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


#: cuDNN's convolution kernels among a profile's device rows (kernel names)
CONV_KERNELS = re.compile(r"conv|fprop|dgrad|wgrad|implicit_gemm", re.IGNORECASE)


def emit_profile(phase, rows, host, wall_ms, **kw):
    busy_ms = sum(r[2] for r in rows)
    conv = [r for r in rows if CONV_KERNELS.search(r[0]) and "lstm_" not in r[0] and "resblock_" not in r[0]]
    emit(phase, wall_ms=wall_ms,
         device_busy_ms=busy_ms if rows else "not measured",
         device_idle_share=(1 - busy_ms / wall_ms) if rows else "not measured",
         cudnn_conv_ms=sum(r[2] for r in conv) if rows else "not measured",
         cudnn_conv_kernels=sum(r[1] for r in conv),
         host_op_ms=sum(r[2] for r in host), host_ops=sum(r[1] for r in host),
         port_kernels=[{"kernel": k[:90], "count": n, "ms": ms} for k, n, ms in rows
                       if "lstm_" in k or "resblock_" in k],
         top=[{"kernel": k[:90], "count": n, "ms": ms} for k, n, ms in rows[:15]],
         top_host=[{"op": k[:60], "count": n, "ms": ms} for k, n, ms in host[:10]], **kw)


def phase_train(torch, cfg, smi, workdir):
    """The training main path: example dataset on disk -> Trainer.fit on
    CUDA from the trained asset, batch 16, dropout on. Returns the trainer
    and the launch counts of the whole run."""
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
    n = Launches()
    n.reset()
    seen = {"lstm_recurrence_training": 0, "lstm_backward": 0, "t": time.perf_counter()}
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
        now_n = n.read()
        b = now_n["lstm_recurrence_training"] - seen["lstm_recurrence_training"]
        c = now_n["lstm_backward"] - seen["lstm_backward"]
        seen["lstm_recurrence_training"], seen["lstm_backward"] = (
            now_n["lstm_recurrence_training"], now_n["lstm_backward"])
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
    counts = n.read()
    check(counts["lstm_recurrence"] == counts["lstm_recurrence_training"],
          "a serving-form launch on the training path")
    changed = sum(int(not torch.equal(before[k], v.detach())) for k, v in model.named_parameters())
    check(changed >= 0.95 * len(before), f"only {changed} of {len(before)} parameter leaves changed")
    moved = sum(int(not torch.equal(stats_before[k], v)) for k, v in model.named_buffers()
                if k in stats_before)
    check(moved == len(stats_before) > 0, f"{moved} of {len(stats_before)} BatchNorm statistics moved")
    check(os.path.exists(os.path.join(workdir, "ckpt", f"step_{n_steps}.pt")), "no checkpoint written")
    check(sum("\"step\"" in line for line in logs) == n_steps, "one metrics line per step expected")
    launches = {k: counts[k] for k in ("lstm_recurrence_training", "lstm_backward")}
    emit("train_summary", steps=n_steps, timed_step_wall_ms=walls[1:],
         mean_timed_step_wall_ms=sum(walls[1:]) / len(walls[1:]),
         leaves_changed=changed, leaves=len(before), batchnorm_statistics_moved=moved,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         max_memory_allocated_gib=torch.cuda.max_memory_allocated() / 2 ** 30, card=smi, **launches)
    check(all(v > 0 for v in launches.values()), f"a kernel of the training path never launched: {launches}")
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


# ---------------------------------------------------------------------------
# 14-17. every acoustic weight form the card reads, and the bf16 acoustic
# model


def reference_state_dict(np, torch, params, stats):
    """The reference's DataParallel STYLER state dict (``checkpoint_<step>
    .pth.tar``'s ``["model"]``) of flax-layout trees: the layout transforms
    of ``core/import_torch.py:import_styler_state`` inverted (Linear kernel
    [in, out] -> weight [out, in], Conv1d kernel [k, in, out] -> weight
    [out, in, k], norms' scale -> weight, LSTM leaves -> torch's
    ``weight_ih_l0_reverse`` names), plus a ``pitch_norm_linear`` and
    BatchNorm step counters, which the importer must ignore."""
    sd = {}

    def lin(dst, t):
        sd[f"{dst}.weight"], sd[f"{dst}.bias"] = t["kernel"].T, t["bias"]

    def conv(dst, t):
        sd[f"{dst}.weight"], sd[f"{dst}.bias"] = t["kernel"].transpose(2, 1, 0), t["bias"]

    def norm(dst, t):
        sd[f"{dst}.weight"], sd[f"{dst}.bias"] = t["scale"], t["bias"]

    def fft(dst, t):
        for n in ("w_qs", "w_ks", "w_vs", "fc"):
            lin(f"{dst}.slf_attn.{n}", t["slf_attn"][n])
        norm(f"{dst}.slf_attn.layer_norm", t["slf_attn"]["layer_norm"])
        conv(f"{dst}.pos_ffn.w_1", t["pos_ffn"]["w_1"])
        conv(f"{dst}.pos_ffn.w_2", t["pos_ffn"]["w_2"])
        norm(f"{dst}.pos_ffn.layer_norm", t["pos_ffn"]["layer_norm"])

    sm, se = params["style_modeling"], "style_modeling.style_encoder"
    ae = f"{se}.audio_encoder"
    sd[f"{se}.text_encoder.src_word_emb.weight"] = sm["text_encoder"]["src_word_emb"]
    for k, v in sm["text_encoder"].items():
        if k.startswith("layer_"):
            fft(f"{se}.text_encoder.layer_stack.{k[6:]}", v)
    for n, b in enumerate("dper", start=1):
        for i in range(3):
            conv(f"{ae}.convolutions_{n}.{i}.0.conv", sm["audio_encoder"][f"convs_{b}"][f"conv_{i}"])
            norm(f"{ae}.convolutions_{n}.{i}.1", sm["audio_encoder"][f"convs_{b}"][f"gn_{i}"])
        for k, v in sm["audio_encoder"][f"lstm_{b}"].items():
            layer, d, w, kind = re.fullmatch(r"l(\d)_(fwd|bwd)_([wb])_(ih|hh)", k).groups()
            name = f"{'weight' if w == 'w' else 'bias'}_{kind}_l{layer}{'_reverse' if d == 'bwd' else ''}"
            sd[f"{ae}.lstm_{n}.{name}"] = v
    for n in ("text_linear_down", "speaker_linear_p", "speaker_linear"):
        lin(f"{se}.{n}.0", sm[n])
    lin("style_modeling.text_linear_up.0", sm["text_linear_up"])
    for f in "dpe":
        c, dst = sm[f"augmentation_classifier_{f}"], f"style_modeling.augmentation_classifier_{f}.classifier"
        lin(f"{dst}.d_fc1", c["d_fc1"])
        norm(f"{dst}.d_bn1", c["d_bn1"])
        lin(f"{dst}.d_fc2", c["d_fc2"])
    for f in ("duration", "pitch", "energy", "residual"):
        lin(f"style_modeling.{f}_linear.0", sm[f"{f}_linear"]["fc1"])
        lin(f"style_modeling.{f}_linear.2", sm[f"{f}_linear"]["fc2"])
    for f in ("duration", "pitch", "energy"):
        p, dst = sm[f"{f}_predictor"], f"style_modeling.{f}_predictor"
        for i in (1, 2):
            conv(f"{dst}.conv_layer.conv1d_{i}.conv", p[f"conv1d_{i}"])
            norm(f"{dst}.conv_layer.layer_norm_{i}", p[f"layer_norm_{i}"])
        lin(f"{dst}.linear_layer", p["linear_layer"])
    for f in ("pitch", "energy"):
        sd[f"style_modeling.{f}_embedding.weight"] = sm[f"{f}_embedding"]["embedding"]
    for k, v in params["decoder"].items():
        fft(f"decoder.layer_stack.{k[6:]}", v)
    lin("mel_linear", params["mel_linear"])
    for i in range(5):
        conv(f"postnet.convolutions.{i}.0.conv", params["postnet"][f"conv_{i}"])
        norm(f"postnet.convolutions.{i}.1", params["postnet"][f"bn_{i}"])
        sd[f"postnet.convolutions.{i}.1.running_mean"] = stats["postnet"][f"bn_{i}"]["mean"]
        sd[f"postnet.convolutions.{i}.1.running_var"] = stats["postnet"][f"bn_{i}"]["var"]
        sd[f"postnet.convolutions.{i}.1.num_batches_tracked"] = np.array(560000)
    sd["style_modeling.pitch_norm_linear.0.weight"] = np.ones((256, 128), np.float32)
    sd["style_modeling.pitch_norm_linear.0.bias"] = np.ones(256, np.float32)
    return {f"module.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


REQUEST_KEYS = ("mel", "mel_noisy", "wav", "wav_noisy", "f0", "energy", "duration")
REQUEST_KEYS_ACOUSTIC = ("log_d", "f0", "energy", "mel", "mel_noisy")


def same_request(np, what, got, want) -> None:
    """Two results of one request, bit for bit."""
    check(got["mel_len"] == want["mel_len"] > 0, f"{what}: mel_len {got['mel_len']} vs {want['mel_len']}")
    differs = {k: float(np.abs(got[k] - want[k]).max()) for k in REQUEST_KEYS
               if not np.array_equal(got[k], want[k])}
    check(not differs, f"{what}: not bit-equal, max |diff| {differs}")


def same_trees(np, what, got, want) -> int:
    """Two flax-style trees, leaf for leaf, bit for bit. Returns the leaf count."""
    from styler_tpu_torch.core.checkpoint import flatten_tree

    got, want = flatten_tree(got), flatten_tree(want)
    check(set(got) == set(want), f"{what}: leaf names differ")
    bad = [k for k in want if not np.array_equal(got[k], want[k])]
    check(not bad, f"{what}: leaves differ: {bad[:4]}")
    return len(want)


def f16_tree(np, tree):
    from styler_tpu_torch.core.checkpoint import flatten_tree, unflatten_tree

    return unflatten_tree({k: v.astype(np.float16).astype(np.float32) for k, v in flatten_tree(tree).items()})


def phase_train_serve(torch, np, trainer, cfg, ref, spk, smi, workdir) -> None:
    """The train -> serve round trip on the card, after ``phase_train``'s
    steps: ``save_checkpoint``, then the trainer's ``step_<N>.pt`` and its
    checkpoint directory (the latest step)
    through ``load_synthesizer``, one request each bit-equal to a
    Synthesizer built from ``to_flax_tree(state.model)``; the exporter's
    ``.npz`` (``python -m styler_tpu_torch.tools.export_acoustic_asset``)
    loads to the float16-rounded trees bit for bit (the Synthesizer of
    those trees) and serves a finite request. Kernels A and B counted on
    each request."""
    import contextlib
    import io

    from styler_tpu_torch.core.checkpoint import default_vocoder_asset, load_vocoder_npz
    from styler_tpu_torch.core.convert import to_flax_tree
    from styler_tpu_torch.synthesis import Synthesizer, load_synthesizer
    from styler_tpu_torch.tools import export_acoustic_asset

    from styler_tpu_torch.train.trainer import save_checkpoint

    step = trainer.state.step
    ckpt_dir = trainer.ckpt_dir
    t0 = time.perf_counter()
    step_file = save_checkpoint(ckpt_dir, trainer.state)
    save_s = time.perf_counter() - t0
    check(step_file == os.path.join(ckpt_dir, f"step_{step}.pt"), f"train_serve: wrote {step_file}")
    params, stats = to_flax_tree(trainer.state.model)
    voc = load_vocoder_npz(default_vocoder_asset("iSTFTNet"))
    cfg_i = cfg.replace(vocoder="iSTFTNet")
    n = Launches()
    want = Synthesizer(cfg_i, params, stats, voc).synthesize(SENTENCES[0], ref, spk)
    rec = {}
    for form, path in (("step_file", step_file), ("directory", ckpt_dir)):
        t0 = time.perf_counter()
        synth = load_synthesizer(cfg, ckpt_path=path)
        load_ms = (time.perf_counter() - t0) * 1e3
        check(synth.device.type == "cuda" and synth.config.vocoder == "iSTFTNet", f"train_serve {form}")
        n.reset()
        got = synth.synthesize(SENTENCES[0], ref, spk)
        torch.cuda.synchronize()
        rec[form] = {"load_ms": load_ms, "launches": n.check_serving(f"train_serve {form}", 36, 2),
                     "bit_equal": True}
        same_request(np, f"train_serve {form}", got, want)
        del synth
    out = os.path.join(workdir, "styler_gen.npz")
    report = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(report):
        check(export_acoustic_asset.main(["--ckpt", ckpt_dir, "--out", out]) == 0, "exporter failed")
    export_s = time.perf_counter() - t0
    synth = load_synthesizer(cfg, ckpt_path=out)
    got_p, got_s = to_flax_tree(synth.model)
    leaves = same_trees(np, "train_serve npz params", got_p, f16_tree(np, params))
    same_trees(np, "train_serve npz stats", got_s, f16_tree(np, stats))
    n.reset()
    got = synth.synthesize(SENTENCES[0], ref, spk)
    launches = n.check_serving("train_serve npz", 36, 2)
    check(got["mel_len"] > 0 and all(bool(np.isfinite(got[k]).all()) for k in REQUEST_KEYS),
          "train_serve npz: empty or non-finite request")
    emit("train_serve", step=step, **rec, npz={"launches": launches, "bit_equal_to_f16_trees": True,
                                               "leaves": leaves},
         save_s=save_s, export_s=export_s, npz_bytes=os.path.getsize(out), export_report=report.getvalue().strip(),
         card=smi)
    del synth
    torch.cuda.empty_cache()


def phase_reference_ckpt(torch, np, cfg, ref, spk, smi, workdir) -> None:
    """A reference ``checkpoint_<step>.pth.tar`` at full width, written
    from the committed asset's trees (``reference_state_dict``), through
    ``load_synthesizer`` with no vocoder named: the vocoder must be HiFi-GAN
    (the published model's), its request bit-equal to the asset's with
    ``vocoder_arch="HiFi-GAN"`` (the same f32 values either way), kernel A
    72 launches a request; then with ``STYLER_TPU_INT8_VOCODER=1`` the
    int8 kernel 72 and its prep pass 4, kernel A none."""
    from styler_tpu_torch.core.checkpoint import default_acoustic_asset, load_acoustic_npz
    from styler_tpu_torch.synthesis import load_synthesizer

    params, stats = load_acoustic_npz(default_acoustic_asset())
    path = os.path.join(workdir, "checkpoint_560000.pth.tar")
    torch.save({"model": reference_state_dict(np, torch, params, stats), "optimizer": {}}, path)
    t0 = time.perf_counter()
    synth = load_synthesizer(cfg, ckpt_path=path)
    load_ms = (time.perf_counter() - t0) * 1e3
    check(synth.config.vocoder == "HiFi-GAN" and not synth.generator.quantize,
          f"reference_ckpt: vocoder {synth.config.vocoder}, not HiFi-GAN")
    t0 = time.perf_counter()
    asset = load_synthesizer(cfg, vocoder_arch="HiFi-GAN")
    asset_load_ms = (time.perf_counter() - t0) * 1e3
    synth.synthesize(SENTENCES[0], ref, spk)  # warm-up
    n = Launches()
    n.reset()
    got = synth.synthesize(SENTENCES[0], ref, spk)
    torch.cuda.synchronize()
    launches = n.read()
    check(launches["resblock_stage"] == 72 and launches["lstm_recurrence"] == 2
          and launches["resblock_stage_int8"] == 0, f"reference_ckpt: launches {launches}")
    same_request(np, "reference_ckpt vs asset", got, asset.synthesize(SENTENCES[0], ref, spk))
    del synth, asset
    os.environ["STYLER_TPU_INT8_VOCODER"] = "1"
    try:
        synth_q = load_synthesizer(cfg, ckpt_path=path)
    finally:
        del os.environ["STYLER_TPU_INT8_VOCODER"]
    check(synth_q.generator.quantize, "reference_ckpt: STYLER_TPU_INT8_VOCODER=1 gave no int8 form")
    n.reset()
    q = synth_q.synthesize(SENTENCES[0], ref, spk)
    torch.cuda.synchronize()
    launches_q = n.read()
    check(launches_q["resblock_stage_int8"] == 72 and launches_q["resblock_stage_int8_prep"] == 4
          and launches_q["resblock_stage"] == 0, f"reference_ckpt int8: launches {launches_q}")
    check(q["mel_len"] == got["mel_len"] and all(bool(np.isfinite(q[k]).all()) for k in REQUEST_KEYS),
          "reference_ckpt int8: mel_len or non-finite output")
    emit("reference_ckpt", file_bytes=os.path.getsize(path), load_ms=load_ms, asset_load_ms=asset_load_ms,
         vocoder="HiFi-GAN", bit_equal_to_asset=True, mel_len=got["mel_len"], launches=launches,
         int8_launches=launches_q, card=smi)
    del synth_q
    os.remove(path)
    torch.cuda.empty_cache()


def phase_random(torch, np, cfg, ref, spk, smi) -> None:
    """``ckpt_path="random"``: two loads give the same weights (a seeded
    CPU generator; its stream depends on the torch version), and one
    forward through kernels A and B (A 36, B 2) is finite in every output,
    padding included. Random predictors may round every duration to 0 (an
    empty request), so the public ``synthesize`` is held to its shapes."""
    from styler_tpu_torch.core.convert import to_flax_tree
    from styler_tpu_torch.synthesis import load_synthesizer

    t0 = time.perf_counter()
    a = load_synthesizer(cfg, ckpt_path="random")
    load_ms = (time.perf_counter() - t0) * 1e3
    b = load_synthesizer(cfg, ckpt_path="random")
    leaves = same_trees(np, "random", to_flax_tree(a.model)[0], to_flax_tree(b.model)[0])
    del b
    M = cfg.mel_buckets[-1]
    rows = a._pack_rows([a.text_to_ids(SENTENCES[-1])], [ref], [spk])
    n = Launches()
    n.reset()
    out, wav, wav_noisy = a._forward(*rows, 1.0, 1.0, 1.0, M)
    torch.cuda.synchronize()
    launches = n.check_serving("random", 36, 2)
    outputs = {"mel_postnet": out.mel_postnet, "mel_postnet_noisy": out.mel_postnet_noisy,
               "log_d": out.log_d_prediction, "f0": out.p_prediction, "energy": out.e_prediction,
               "wav": wav, "wav_noisy": wav_noisy}
    finite = {k: bool(torch.isfinite(v).all()) for k, v in outputs.items()}
    check(all(finite.values()), f"random: non-finite outputs {finite}")
    res = a.synthesize(SENTENCES[-1], ref, spk)
    ml = res["mel_len"]
    check(ml == int(out.mel_len[0]) and 0 <= ml <= M and res["wav"].shape == (ml * cfg.hop_length,)
          and res["mel"].shape == (ml, cfg.n_mel_channels), f"random: mel_len {ml}, shapes")
    emit("random", load_ms=load_ms, leaves_equal=leaves, vocoder=a.config.vocoder, mel_len=ml,
         log_d_range=[float(out.log_d_prediction.min()), float(out.log_d_prediction.max())],
         finite=finite, launches=launches, card=smi)
    del a
    torch.cuda.empty_cache()


#: the floor of a bf16 bound on the card: two bfloat16 steps of the
#: output's mean magnitude. The card's bf16-vs-f32 pitch prediction came
#: out 5.4x the CPU's on one sentence and 1.2x on the others (both half a
#: bfloat16 step of the scale or less), so one CPU realisation is too small
#: a yardstick alone.
BF16_FLOOR = 2.0 ** -7


def hold_bf16(np, fails, what, port, other, own_b, own_f) -> dict:
    """A bf16 result ``port`` against ``other`` (the port's bf16 on the
    CPU, or the card's f32), held as ``tests/test_torch_bf16.py`` holds the
    port to the JAX package: mean |port - other| within twice the CPU
    port's own bf16-vs-f32 distance (``own_b`` vs ``own_f``, which that test
    holds to the JAX package's) plus ``BF16_FLOOR`` of the output's mean
    magnitude. A miss is appended to ``fails``."""
    a, b, ob, of = (np.asarray(x, np.float64) for x in (port, other, own_b, own_f))
    if a.shape != b.shape or ob.shape != of.shape:
        fails.append(f"{what}: shapes {a.shape} / {b.shape} / {ob.shape} / {of.shape}")
        return {"shapes": [list(a.shape), list(b.shape)]}
    d, d_own = float(np.abs(a - b).mean()), float(np.abs(ob - of).mean())
    bound = 2 * d_own + BF16_FLOOR * float(np.abs(of).mean())
    if not (bool(np.isfinite(a).all()) and d <= bound):
        fails.append(f"{what}: mean |diff| {d} > {bound} (2 x CPU bf16-vs-f32 {d_own} + floor)")
    return {"mean_abs": d, "bound": bound, "cpu_bf16_vs_f32": d_own}


def hold_bf16_request(np, bins, fails, what, got, other, cpu_b, cpu_f) -> dict:
    """One bf16 request's acoustic outputs ``got`` (``acoustic``) on the
    card against ``other`` (``hold_bf16``, misses appended to ``fails``):
    the log-durations; every rounded duration equal, or both continuous
    values within bf16 noise of the rounding edge between them (twice the
    CPU pair's largest difference of exp(log_d) - 1, at least 2^-6 of the
    value). Where no duration differs, f0 and energy; a frame whose f0 or
    energy takes another embedding bin (``bin_flips``: bf16 noise against
    bins a few Hz wide flips some) must differ by no more than twice the
    CPU pair's largest bf16-vs-f32 difference of that value plus
    ``BF16_FLOOR`` of its largest magnitude. Where no bin flips either, the
    two mels; else their distances are reported, and the teacher-forced
    forward holds the mel without the discrete steps."""
    rec = {"phonemes": len(got["log_d"]),
           "log_d": hold_bf16(np, fails, f"{what} log_d", got["log_d"], other["log_d"],
                              cpu_b["log_d"], cpu_f["log_d"])}
    raw_g, raw_o, raw_b, raw_f = (np.exp(x["log_d"]) - 1.0 for x in (got, other, cpu_b, cpu_f))
    flips = np.nonzero(np.round(raw_g) != np.round(raw_o))[0]
    own = 2 * float(np.abs(raw_b - raw_f).max())
    for i in flips:
        edge = np.floor(max(raw_g[i], raw_o[i])) + 0.5
        noise = max(own, 4 * 2.0 ** -8 * max(abs(raw_o[i]), 1.0))
        if not (abs(raw_g[i] - edge) <= noise and abs(raw_o[i] - edge) <= noise):
            fails.append(f"{what}: phoneme {i} rounds to {np.round(raw_g[i])} vs {np.round(raw_o[i])} "
                         f"away from an edge ({raw_g[i]} vs {raw_o[i]}, noise {noise})")
    rec["duration_flips"] = int(len(flips))
    own_flips = int((np.round(raw_b) != np.round(raw_f)).sum())
    rec["cpu_bf16_vs_f32_duration_flips"] = own_flips
    if len(flips) or own_flips or not (got["mel_len"] == other["mel_len"] == cpu_b["mel_len"] == cpu_f["mel_len"]):
        return rec
    for k in ("f0", "energy"):
        rec[k] = hold_bf16(np, fails, f"{what} {k}", got[k], other[k], cpu_b[k], cpu_f[k])
    flipped = bin_flips(np, bins, got, other)
    for k in ("f0", "energy"):
        frames = flipped.get(f"{k}_bin_frames", [])
        noise = (2 * float(np.abs(cpu_b[k] - cpu_f[k]).max()) + BF16_FLOOR * float(np.abs(cpu_f[k]).max()))
        gap = float(np.abs(got[k][frames] - other[k][frames]).max()) if frames else 0.0
        if gap > noise:
            fails.append(f"{what}: {k} takes another bin {gap} away, beyond bf16 noise {noise}")
        rec[f"{k}_bin_flips"] = len(frames)
    for k in ("mel", "mel_noisy"):
        if flipped:
            rec[k] = {"mean_abs": float(np.abs(got[k] - other[k]).mean()), "held": False}
        else:
            rec[k] = hold_bf16(np, fails, f"{what} {k}", got[k], other[k], cpu_b[k], cpu_f[k])
    return rec


def acoustic(torch, synth, sentence, ref, spk, targets=None) -> dict:
    """``synth.model``'s eval forward on one request, free, or teacher-forced
    with ``targets`` (rounded durations over the phonemes, f0 and energy
    over the frames, numpy) so that no rounding edge or embedding bin can
    move: log-durations over the phonemes, f0, energy and the two mels over
    the output frames, as float64 numpy, and the output length."""
    import numpy as np

    src_seq, src_len, mel, f0, en, mel_len, spk_t = synth._pack_rows(
        [synth.text_to_ids(sentence)], [ref], [spk])
    L, M, n = src_seq.shape[1], mel.shape[1], int(src_len[0])
    kw = {}
    if targets is not None:
        d, p, e = targets
        dt, pt, et = np.zeros((1, L), np.int64), np.zeros((1, M), np.float32), np.zeros((1, M), np.float32)
        dt[0, :n] = d[:n]
        pt[0, : min(len(p), M)], et[0, : min(len(e), M)] = p[:M], e[:M]
        kw = {k: torch.from_numpy(v).to(synth.device) for k, v in
              (("d_target", dt), ("p_target", pt), ("e_target", et))}
    M_out = M if targets is not None else synth.config.mel_buckets[-1]
    with torch.no_grad():
        out = synth.model(src_seq, mel, mel, f0, en, src_len, mel_len, M_out, spk_t, **kw)
    ml = int(out.mel_len[0])
    cut = {"log_d": ("log_d_prediction", n), "f0": ("p_prediction", ml), "energy": ("e_prediction", ml),
           "mel": ("mel_postnet", ml), "mel_noisy": ("mel_postnet_noisy", ml)}
    res = {k: getattr(out, name)[0, :m].double().cpu().numpy() for k, (name, m) in cut.items()}
    res["mel_len"] = ml
    return res


def profile_one(torch, fn):
    """(device kernel rows, host rows, wall ms) of ``fn()`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return (*profile_rows(torch, prof), wall_ms)


def phase_bf16(torch, np, synth, cfg, ref, ref2, spk, spk2, smi, workdir) -> None:
    """The bf16 acoustic model (``compute_dtype="bfloat16"``) on the card,
    beside the f32 one (``synth``) in the same call:

    - one untimed request under ``Capture``: kernels A and B held against
      their plain versions, kernel B's gates and weights float32;
    - ``run_requests``' 3 sentences (A 36, B 2 a request, nothing else),
      each against the port's bf16 on the CPU and against the card's f32
      (``hold_bf16_request``);
    - one request profiled in bf16 and in f32: wall, device busy, idle
      share, cuDNN convolution ms;
    - a 16-row ``synthesize_batch`` in each dtype: wall, busy, audio s per
      wall s;
    - one bundle entry at B = 1 in each dtype (captured CUDA graph): the
      bf16 replay bit-equal to bf16 eager; request walls in turns."""
    from styler_tpu_torch.core.config import bucket_for
    from styler_tpu_torch.core.export import BundleSynthesizer, save_serving_bundle
    from styler_tpu_torch.synthesis import load_synthesizer

    cfg_b = cfg.replace(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    sb = load_synthesizer(cfg_b)
    load_s = time.perf_counter() - t0
    check(sb.model.decoder.layer_0.slf_attn.w_qs.compute_dtype == torch.bfloat16, "bf16: not the bf16 model")
    with Capture(sb) as cap:
        sb.synthesize(SENTENCES[-1], ref, spk)
        torch.cuda.synchronize()
    held = hold_kernels(torch, "bf16", cap)
    gate_dtypes = sorted({f"{a[0].dtype}/{a[1].dtype}" for a, _, _ in cap.calls["lstm_recurrence"]})
    check(gate_dtypes == ["torch.float32/torch.float32"], f"bf16: kernel B's operands {gate_dtypes}")
    del cap
    outs_b, launches = run_requests(torch, sb, ref, spk, cfg, "bf16_main", smi)
    check(launches["resblock_stage"] == 36 * len(SENTENCES) and launches["lstm_recurrence"] == 2 * len(SENTENCES)
          and launches["resblock_stage_int8"] == launches["lstm_backward"] == 0
          and launches["lstm_recurrence_training"] == 0, f"bf16: launches {launches}")
    t0 = time.perf_counter()
    cpu_b, cpu_f = load_synthesizer(cfg_b, device="cpu"), load_synthesizer(cfg, device="cpu")
    held_requests, fails = [], []
    sm = sb.model.style_modeling
    bins = (sm.pitch_bins.cpu().numpy(), sm.energy_bins.cpu().numpy())
    pairs = (("card_vs_cpu", "cpu_b"), ("bf16_vs_f32", "card_f"))
    models = (("card_b", sb), ("card_f", synth), ("cpu_b", cpu_b), ("cpu_f", cpu_f))
    for s, g in zip(SENTENCES, outs_b):
        # the acoustic model alone (the vocoder is the same bf16 one in
        # both modes): free, then teacher-forced with the CPU f32 request's
        # rounded durations, f0 and energy, which holds the mel with no
        # discrete step in the way
        free = {name: acoustic(torch, s_, s, ref, spk) for name, s_ in models}
        check(free["card_b"]["mel_len"] == g["mel_len"]
              and np.array_equal(free["card_b"]["mel"], g["mel"].astype(np.float64)),
              f"bf16 '{s[:12]}': the acoustic forward is not synthesize()'s")
        cf = free["cpu_f"]
        targets = (np.clip(np.round(np.exp(cf["log_d"]) - 1.0), 0, None).astype(np.int64), cf["f0"], cf["energy"])
        tf = {name: acoustic(torch, s_, s, ref, spk, targets) for name, s_ in models}
        f = synth.synthesize(s, ref, spk)
        rec = {"sentence": s[:24], "mel_len": g["mel_len"],
               "wav_log_mel_mae_bf16_vs_f32": [
                   float(np.abs(sb.frontend(g[k])[0] - sb.frontend(f[k])[0]).mean()) if g["mel_len"] == f["mel_len"]
                   else None for k in ("wav", "wav_noisy")]}
        for pair, other in pairs:
            rec[pair] = hold_bf16_request(np, bins, fails, f"bf16 {pair} '{s[:12]}'", free["card_b"],
                                          free[other], free["cpu_b"], free["cpu_f"])
        rec["teacher_forced"] = {
            pair: {k: hold_bf16(np, fails, f"bf16 teacher-forced {pair} '{s[:12]}' {k}", tf["card_b"][k],
                                tf[other][k], tf["cpu_b"][k], tf["cpu_f"][k]) for k in REQUEST_KEYS_ACOUSTIC}
            for pair, other in pairs}
        # bf16 is really taken on the card: its mel is not the f32 one
        if not rec["teacher_forced"]["bf16_vs_f32"]["mel"]["mean_abs"] > 0:
            fails.append(f"bf16 '{s[:12]}': the card's bf16 mel equals its f32 mel")
        held_requests.append(rec)
    cpu_s = time.perf_counter() - t0
    del cpu_b, cpu_f
    emit("bf16", load_s=load_s, cpu_compare_s=cpu_s, kernels_held=held, kernel_b_operands=gate_dtypes,
         launches=launches, requests=held_requests, failures=fails, card=smi)
    check(not fails, "bf16: " + "; ".join(fails))

    prof = {}
    for name, s_ in (("bf16", sb), ("f32", synth)):
        s_.synthesize(SENTENCES[-1], ref, spk)
        rows, host, wall_ms = profile_one(torch, lambda: s_.synthesize(SENTENCES[-1], ref, spk))
        prof[name] = rows
        emit_profile(f"bf16_profile_{name}", rows, host, wall_ms, sentence=SENTENCES[-1], card=smi)

    rows = [(s, (ref, ref2)[j], (spk, spk2)[j]) for s in BATCH_SENTENCES for j in (0, 1)]
    sentences, refs, spks = (list(c) for c in zip(*rows))
    for name, s_ in (("bf16", sb), ("f32", synth)):
        s_.synthesize_batch(sentences, refs, spks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = s_.synthesize_batch(sentences, refs, spks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        audio_s = sum(r["mel_len"] for r in res) * cfg.hop_length / cfg.sampling_rate
        check(all(bool(np.isfinite(r["wav"]).all()) for r in res), f"bf16 batch ({name}): non-finite")
        prow, phost, pwall = profile_one(torch, lambda: s_.synthesize_batch(sentences, refs, spks))
        emit_profile(f"bf16_batch_{name}", prow, phost, pwall, batch_rows=len(res), unprofiled_wall_ms=wall_ms,
                     audio_s=audio_s, audio_s_per_wall_s=audio_s / (wall_ms / 1e3), card=smi)

    ids = sb.text_to_ids(SENTENCES[-1])
    L = bucket_for(len(ids), cfg.src_buckets)
    M_in = bucket_for(ref.mel_len, cfg.mel_buckets)
    bundles, walls = {}, {"bf16": [], "f32": []}
    n = Launches()
    for name, s_ in (("bf16", sb), ("f32", synth)):
        out = os.path.join(workdir, f"bundle_dtype_{name}")
        manifest = save_serving_bundle(s_, out, src_buckets=(L,), mel_buckets=sorted({M_in, cfg.mel_buckets[-1]}))
        check(manifest["config"]["compute_dtype"] == s_.config.compute_dtype, f"bundle {name}: dtype not recorded")
        bundles[name] = BundleSynthesizer(out, cfg)
        check(bundles[name].bundle.config.compute_dtype == s_.config.compute_dtype, f"bundle {name}: dtype")
        n.reset()
        bundles[name].synthesize(SENTENCES[-1], ref, spk)  # the capture
        at_capture = n.read()
        check(at_capture["resblock_stage"] == 72 and at_capture["lstm_recurrence"] == 4,
              f"bundle {name}: launches at capture {at_capture}")
    n.reset()
    got = bundles["bf16"].synthesize(SENTENCES[-1], ref, spk)
    check(sum(n.read().values()) == 0, "bf16 bundle: a kernel launched at replay")
    want = sb.synthesize(SENTENCES[-1], ref, spk)
    check(got["mel_len"] == want["mel_len"], "bf16 bundle: mel_len")
    differs = [k for k in ("mel", "mel_noisy", "wav", "wav_noisy", "f0", "energy")
               if not np.array_equal(got[k], want[k])]
    check(not differs, f"bf16 bundle: replay not bit-equal to eager in {differs}")
    for _ in range(4):
        for name in ("bf16", "f32", "f32", "bf16"):
            t0 = time.perf_counter()
            bundles[name].synthesize(SENTENCES[-1], ref, spk)
            walls[name].append((time.perf_counter() - t0) * 1e3)
    emit("bf16_bundle", entry=[1, L, M_in], replay_bit_equal_to_eager=True,
         request_wall_ms=walls, mean_wall_ms={k: sum(v) / len(v) for k, v in walls.items()}, card=smi)
    for name in bundles:
        shutil.rmtree(os.path.join(workdir, f"bundle_dtype_{name}"), ignore_errors=True)
    del bundles, sb
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to measure", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    import numpy as np

    from styler_tpu_torch.core.config import bucket_for, default_config
    from styler_tpu_torch.core.device import resolve_device
    from styler_tpu_torch.data.audio_io import read_wav_int
    from styler_tpu_torch.ops import build
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
    ptxas = ptxas_summary(build.ptxas_report)
    emit("build", seconds=time.perf_counter() - t0, libraries=libs, ptxas=ptxas)
    for lib in ("resblock", "resblock_int8", "lstm", "lstm_bwd"):
        spills = [e["function"] for e in ptxas[lib] if e["spill_store_bytes"] or e["spill_load_bytes"]]
        check(len(ptxas[lib]) > 1 and not spills, f"{lib}: ptxas spills in {spills}")

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

    # 3b. the trained speaker encoder, card against CPU
    embedder = phase_speaker(torch, cfg, smi)

    # 4. the main path: 3 requests after one warm-up request
    sr, wav = read_wav_int(os.path.join(ROOT, "assets", "vocoder", "val", "val_0000.wav"))
    check(sr == cfg.sampling_rate, f"reference wav at {sr} Hz")
    ref = extract_reference_features(wav.astype(np.float32), cfg, synth.frontend)
    spk = embedder.embed_wav(wav.astype(np.float32) / cfg.max_wav_value)
    outs, launches = run_requests(torch, synth, ref, spk, cfg, "main", smi)
    emit("main_launches", **launches)
    check(launches["resblock_stage"] > 0 and launches["lstm_recurrence"] > 0,
          f"a kernel of the main path never launched: {launches}")
    check(launches["lstm_recurrence_training"] == launches["lstm_backward"] == 0
          and launches["resblock_stage_int8"] == 0, "serving launched a training or an int8 kernel")
    phase_profile(torch, synth, SENTENCES[-1], ref, spk)

    # 5. card vs CPU on the first request
    card_vs_cpu(torch, synth, load_synthesizer(cfg, device="cpu"), outs[0], ref, spk, "card_vs_cpu")

    # 6. the rest of the Synthesizer: warmup, batch, profile_batch, long,
    # inspect, mix, residual_off. The second reference lies in the first's
    # mel bucket (512): the audio encoder's GroupNorm takes its statistics
    # over the padded frames too (styler_tpu/models/audio_encoder.py:95),
    # so a batch row equals its single request only at the same bucket.
    sr, wav2 = read_wav_int(os.path.join(ROOT, "assets", "vocoder", "val", "val_0002.wav"))
    ref2 = extract_reference_features(wav2.astype(np.float32), cfg, synth.frontend)
    check(bucket_for(ref2.mel_len, cfg.mel_buckets) == bucket_for(ref.mel_len, cfg.mel_buckets),
          "the two references lie in different mel buckets")
    spk2 = embedder.embed_wav(wav2.astype(np.float32) / cfg.max_wav_value)
    phase_serving(torch, synth, cfg, ref, ref2, spk, spk2, smi)

    # 6b. serving from reference audio: load_reference, the server's
    # request handler, and the two entry points as child processes
    refroot = tempfile.mkdtemp(prefix="smoke-refs-", dir=os.path.join(ROOT, "styler_tpu_torch", "_build"))
    try:
        cfg_ref = cfg.replace(**write_reference_dir(np, refroot))
        phase_reference(synth, cfg_ref, embedder, smi)
        phase_serve(torch, synth, cfg_ref, smi, os.path.join(refroot, "serve"))
        phase_serve_cli(np, cfg_ref, smi, refroot)
        # 6c. the serving bundle: CUDA graphs per entry, and the server on it
        bs, bundle_dir = phase_bundle(torch, synth, cfg, ref, spk, smi, refroot)
        phase_serve_bundle(torch, np, synth, bs, bundle_dir, cfg_ref, smi, refroot)
        del bs
        torch.cuda.empty_cache()
        # 14. the bf16 acoustic model beside the f32 one
        phase_bf16(torch, np, synth, cfg, ref, ref2, spk, spk2, smi, refroot)
    finally:
        shutil.rmtree(refroot, ignore_errors=True)
    del synth
    torch.cuda.empty_cache()

    # 7-10. the HiFi-GAN serving path, exact and int8
    rec_h, rec_q, launches_h, launches_q = phase_hifigan(torch, cfg, mel2b, ref, spk, smi)

    # 15-16. a reference checkpoint_<step>.pth.tar (HiFi-GAN kept) and
    # "random" acoustic weights
    formdir = tempfile.mkdtemp(prefix="smoke-forms-", dir=os.path.join(ROOT, "styler_tpu_torch", "_build"))
    try:
        phase_reference_ckpt(torch, np, cfg, ref, spk, smi, formdir)
    finally:
        shutil.rmtree(formdir, ignore_errors=True)
    phase_random(torch, np, cfg, ref, spk, smi)

    # 11-13. the training main path
    workdir = tempfile.mkdtemp(prefix="smoke-train-", dir=os.path.join(ROOT, "styler_tpu_torch", "_build"))
    try:
        trainer, train_launches = phase_train(torch, cfg, smi, workdir)
        phase_train_profile(torch, trainer)
        # 17. the train -> serve round trip: step_<N>.pt, its directory, the exporter
        phase_train_serve(torch, np, trainer, cfg, ref, spk, smi, workdir)
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
         "ns_per_step": rec_b["ns_per_step"],
         # its training form, per train step (4 launches), on the training path
         "training_form": {"launches": train_launches["lstm_recurrence_training"], **rec_b_train}},
        {"name": "lstm_backward", **common, "source": "styler_tpu_torch/csrc/lstm_bwd.cu",
         "replaces": "styler_tpu/ops/pallas_lstm.py:169",
         "launches": train_launches["lstm_backward"], "max_abs_err": rec_c["max_abs_err"],
         "ms": rec_c["ms"], "plain_ms": rec_c["plain_ms"], "bound_ms": rec_c["bound_ms"],
         "bound_by": rec_c["bound_by"], "library_ms": rec_c["library_ms"],
         "ns_per_step": rec_c["ns_per_step"], "walk_ms": rec_c["walk_ms"], "dw_ms": rec_c["dw_ms"]},
    ]
    emit("total", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
