#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``styler_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  — the card's name and power limit; fails without a CUDA device.
2. build   — builds every kernel from ``styler_tpu_torch/csrc`` (one nvcc
             per source, in parallel) and prints the ptxas register /
             shared-memory / spill summary.
3. kernels — each kernel against its plain PyTorch version at the shapes
             the main path gives it, with the tolerance stated, and CUDA-event
             times of the kernel, the plain version, a PyTorch library call
             computing the same function (a yardstick the port never calls)
             and the card's lower bound for the same work.
4. main    — ``load_synthesizer(default_config())`` on CUDA, reference
             features of ``assets/vocoder/val/val_0000.wav``, a seeded
             unit-norm speaker embedding, and ``synthesize`` on 3 sentences;
             checks shapes, finiteness and that both kernels were launched.
   A profiled request follows (device time by kernel, idle share).
5. card_vs_cpu — one request again with ``device="cpu"`` (plain versions);
             durations and mels at f32 tolerance, waveforms by SNR (bf16).

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line is printed. Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published dense peaks of one H100 SXM (NVIDIA data sheet)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12  # f32 outside the tensor cores (no TF32)
HBM_BYTES_PER_S = 3.35e12

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


def phase_resblock(torch, synth_gen, mel2b):
    """Kernel A vs plain on both iSTFTNet stages at the main path's shapes
    and data (the stage inputs of a 2B batch of 1024-frame mels)."""
    import torch.nn.functional as F

    from styler_tpu_torch.ops.resblock import fused_resblock_stage, resblock_stage_plain

    g = synth_gen
    ks = tuple(g.config.resblock_kernel_sizes)
    dils = tuple(g.config.resblock_dilation_sizes[0])

    # the stage inputs the main path produces for the 2B mel batch
    with torch.no_grad():
        x = g._conv(g.conv_pre, mel2b)
        stage_in = []
        for i in range(2):
            x = getattr(g, f"ups_{i}")(F.leaky_relu(x, 0.1)).contiguous()
            stage_in.append(x)
            blocks = [getattr(g, f"resblocks_{i}_{j}") for j in range(len(ks))]
            x = fused_resblock_stage(x, [b.branch_params() for b in blocks], ks, dils)

    rec_a = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0}
    flops_a = bytes_a = 0.0
    for i, x_bf in enumerate(stage_in):
        blocks = [getattr(g, f"resblocks_{i}_{j}") for j in range(len(ks))]
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
                check(bool(torch.isfinite(got).all()), f"resblock stage {i} {dtype}: non-finite output")
                check(err <= tol * max(scale, 1.0),
                      f"resblock stage {i} {dtype}: max |kernel - plain| {err} > {tol} x {scale}")
                ms = cuda_ms(torch, lambda: fused_resblock_stage(x_in, bp, ks, dils), 5)
                plain_ms = cuda_ms(torch, lambda: resblock_stage_plain(x_in, bp, ks, dils), 2)
                bpc = [tuple(t.permute(0, 3, 2, 1).contiguous() if t.dim() == 4 else t.to(dtype)
                             for t in b) for b in bp]  # [n_dil, Cout, Cin, k] for F.conv1d
                lib_ms = cuda_ms(torch, lambda: resblock_library(torch, F, x_in, bpc, ks, dils), 5)
            B, T, C = x_in.shape
            esz = x_in.element_size()
            flops = 2.0 * B * T * C * C * 2 * len(dils) * sum(ks)
            n_bytes = 2 * B * T * C * esz + 2 * len(dils) * sum(ks) * C * C * esz + 2 * len(dils) * len(ks) * C * 4
            b_ms, b_by = bound(flops, peak, n_bytes)
            emit("kernels", kernel="resblock_stage", stage=i, shape=[B, T, C], dtype=str(dtype),
                 max_abs_err=err, out_scale=scale, tolerance=f"{tol} x max|plain|",
                 ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                 flops=flops, bytes=n_bytes, launches_per_request=2 * len(dils) * len(ks))
            if dtype == torch.bfloat16:  # the main path's dtype
                rec_a["ms"] += ms
                rec_a["plain_ms"] += plain_ms
                rec_a["library_ms"] += lib_ms
                rec_a["max_abs_err"] = max(rec_a["max_abs_err"], err)
                flops_a += flops
                bytes_a += n_bytes
    rec_a["bound_ms"], rec_a["bound_by"] = bound(flops_a, PEAK_BF16, bytes_a)
    return rec_a


def phase_lstm(torch, model, cfg):
    """Kernel B vs plain on one BiLSTM layer of the audio encoder at the
    largest src bucket, the asset's weights, inputs of post-ReLU scale."""
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
        check(bool(torch.isfinite(got).all()), "lstm: non-finite output")
        check(err <= tol, f"lstm: max |kernel - plain| {err} > {tol}")
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
    emit("kernels", kernel="lstm_recurrence", shape={"S": len(gates), "B": 1, "T": T, "Hp": hp},
         hiddens=hiddens, valid_length=int(lengths[0]), max_abs_err=err, tolerance=tol,
         ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
         flops=flops, bytes=n_bytes, launches_per_request=2)
    n_layers = len(lstms[0].layer_params())
    return {"ms": n_layers * ms, "plain_ms": n_layers * plain_ms, "library_ms": n_layers * lib_ms,
            "bound_ms": n_layers * b_ms, "bound_by": b_by, "max_abs_err": err}


def phase_profile(torch, synth, sentence, ref, spk) -> None:
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
    # device-side events only: an aten op's own row repeats its kernels' time
    rows = [
        (e.key, e.count, e.self_device_time_total / 1e3)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    rows = sorted((r for r in rows if r[2] > 0), key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in rows)
    # host side: operators by their own CPU time (launches included)
    host = sorted(
        ((e.key, e.count, e.self_cpu_time_total / 1e3) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CPU),
        key=lambda r: -r[2],
    )
    emit("profile", sentence=sentence, wall_ms=wall_ms, text_to_ids_ms=text_ms,
         device_busy_ms=busy_ms if rows else "not measured",
         device_idle_share=(1 - busy_ms / wall_ms) if rows else "not measured",
         host_op_ms=sum(r[2] for r in host), host_ops=sum(r[1] for r in host),
         top=[{"kernel": k[:90], "count": n, "ms": ms} for k, n, ms in rows[:15]],
         top_host=[{"op": k[:60], "count": n, "ms": ms} for k, n, ms in host[:10]])


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
    from styler_tpu_torch.ops.lstm import lstm_recurrence
    from styler_tpu_torch.ops.resblock import fused_resblock_stage
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
    rec_a = phase_resblock(torch, synth.generator, mel2b)
    rec_b = phase_lstm(torch, synth.model, cfg)

    # 4. the main path: 3 requests after one warm-up request
    sr, wav = read_wav_int(os.path.join(ROOT, "assets", "vocoder", "val", "val_0000.wav"))
    check(sr == cfg.sampling_rate, f"reference wav at {sr} Hz")
    ref = extract_reference_features(wav.astype(np.float32), cfg, synth.frontend)
    spk = np.random.default_rng(0).standard_normal(cfg.speaker_embed_dim).astype(np.float32)
    spk /= np.linalg.norm(spk)
    synth.synthesize(SENTENCES[0], ref, spk)
    torch.cuda.synchronize()
    fused_resblock_stage.launches = 0
    lstm_recurrence.launches = 0
    outs = []
    for s in SENTENCES:
        t0 = time.perf_counter()
        out = synth.synthesize(s, ref, spk)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        ml = out["mel_len"]
        check(0 < ml <= M, f"mel_len {ml}")
        check(out["mel"].shape == (ml, cfg.n_mel_channels) and out["mel_noisy"].shape == out["mel"].shape,
              "mel shape")
        check(out["wav"].shape == (ml * cfg.hop_length,) == out["wav_noisy"].shape, "wav shape")
        for k in ("mel", "mel_noisy", "wav", "wav_noisy", "f0", "energy", "duration"):
            check(bool(np.isfinite(out[k]).all()), f"non-finite {k}")
        outs.append(out)
        emit("main", sentence=s, phonemes=int((~out["src_mask"][0]).sum()), mel_len=ml,
             wall_ms=wall_ms, card=smi)
    launches = {"resblock_stage": fused_resblock_stage.launches,
                "lstm_recurrence": lstm_recurrence.launches}
    emit("main_launches", **launches)
    check(all(n > 0 for n in launches.values()), f"a kernel of the main path never launched: {launches}")
    phase_profile(torch, synth, SENTENCES[-1], ref, spk)

    # 5. card vs CPU on the first request
    cpu = load_synthesizer(cfg, device="cpu")
    c = cpu.synthesize(SENTENCES[0], ref, spk)
    g = outs[0]
    check(c["mel_len"] == g["mel_len"], f"mel_len card {g['mel_len']} vs cpu {c['mel_len']}")
    res = {}
    # f32 acoustic model, TF32 off: sums in another order only
    for k, tol in (("duration", 1e-4), ("mel", 1e-3), ("mel_noisy", 1e-3)):
        scale = max(float(np.abs(c[k]).max()), 1.0)
        err = float(np.abs(g[k] - c[k]).max())
        res[k] = {"max_abs_err": err, "tolerance": tol * scale}
        check(err <= tol * max(scale, 1.0), f"card vs cpu {k}: {err} > {tol} x {scale}")
    # bf16 vocoder: conv_post emits the iSTFT phase in bf16, so one bf16
    # rounding flip moves samples a lot and sample SNR is fragile (bf16 vs
    # f32 of the same path measures 5 to 17 dB); hold the log-mels of the
    # waveforms instead (bf16 vs f32 measures 0.03 to 0.06, natural log)
    for k in ("wav", "wav_noisy"):
        c64 = c[k].astype(np.float64)
        snr = float(10 * np.log10((c64 ** 2).sum() / max(((g[k] - c64) ** 2).sum(), 1e-30)))
        mae = float(np.abs(cpu.frontend(g[k])[0] - cpu.frontend(c[k])[0]).mean())
        res[k] = {"log_mel_mae": mae, "tolerance": 0.1, "snr_db": snr}
        check(mae < 0.1, f"card vs cpu {k}: log-mel MAE {mae}")
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
    check(snr > 50.0, f"card vs cpu f32 vocoder: SNR {snr} dB")
    emit("card_vs_cpu", sentence=SENTENCES[0], **res)

    common = {"route": "cuda"}
    kernels = [
        {"name": "resblock_stage", **common, "source": "styler_tpu_torch/csrc/resblock.cu",
         "replaces": "styler_tpu/ops/pallas_resblock.py:311",
         "launches": launches["resblock_stage"], "max_abs_err": rec_a["max_abs_err"],
         "ms": rec_a["ms"], "plain_ms": rec_a["plain_ms"], "bound_ms": rec_a["bound_ms"],
         "bound_by": rec_a["bound_by"], "library_ms": rec_a["library_ms"]},
        {"name": "lstm_recurrence", **common, "source": "styler_tpu_torch/csrc/lstm.cu",
         "replaces": "styler_tpu/ops/pallas_lstm.py:76",
         "launches": launches["lstm_recurrence"], "max_abs_err": rec_b["max_abs_err"],
         "ms": rec_b["ms"], "plain_ms": rec_b["plain_ms"], "bound_ms": rec_b["bound_ms"],
         "bound_by": rec_b["bound_by"], "library_ms": rec_b["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
