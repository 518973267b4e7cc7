"""Tile sweep of kernel A's bf16 mode (``csrc/resblock.cu``) on one GPU.

    python -m styler_tpu_torch.tools.resblock_tiles [--out FILE]

For every tile the kernel has for the N tile of a stage (BN = 32, 64 or
128 by C), forces that tile, runs the whole resblock stage (3 branches x
3 dilations x 2 convs = 18 launches, kernel sizes 3/7/11, dilations
1/3/5) at the four HiFi-GAN stage shapes of a 2 x 1024-frame mel batch
([2, 8192, 256] .. [2, 262144, 32]; the iSTFTNet path's two stages are
the first two), checks it against the plain version (3e-2 of the output
scale) and prints its CUDA-event time with the launch plan of its
largest conv (k = 11, dil = 5). Then, per stage with its usual tile, one
conv pair (a single branch and dilation, 2 launches) at k = 3 and at
k = 11: both move the same bytes, so the difference is 16 taps of
products, and ``tap_tflops`` is the rate of the kernel's product loop
apart from its loads and epilogue. Inputs and weights are seeded normals;
the kernel's time does not depend on their values. One JSON line per
(stage, tile) and per stage's pairs, then a summary line; ``--out`` also
writes them to a file. Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from styler_tpu_torch.core.device import resolve_device
from styler_tpu_torch.ops.resblock import (
    bf16_launch_plan,
    force_bf16_tile,
    fused_resblock_stage,
    resblock_stage_plain,
)

#: the HiFi-GAN stage inputs of the main path (B = 2 mels of 1024 frames)
STAGES = ((2, 8192, 256), (2, 65536, 128), (2, 131072, 64), (2, 262144, 32))
#: (BM, warp width, threads) of every tile per BN, as csrc/resblock.cu's TILES
TILES = {32: ((256, 32, 256), (128, 32, 256)),
         64: ((256, 64, 256), (128, 64, 256)),
         128: ((128, 64, 256), (256, 64, 512), (64, 64, 256))}
KS, DILS = (3, 7, 11), (1, 3, 5)


def _time_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lines = []

    def emit(**kw):
        lines.append(json.dumps(kw))
        print(lines[-1], flush=True)

    rng = np.random.default_rng(0)
    best = {}
    ok = True
    for si, (B, T, C) in enumerate(STAGES):
        bn = 32 if C <= 32 else 64 if C <= 64 else 128
        bp = []
        for k in KS:
            w = [torch.from_numpy((rng.standard_normal((len(DILS), k, C, C)) * (0.5 / np.sqrt(k * C)))
                                  .astype(np.float32)).to(dev, torch.bfloat16) for _ in range(2)]
            b = [torch.from_numpy((rng.standard_normal((len(DILS), C)) * 0.01).astype(np.float32)).to(dev)
                 for _ in range(2)]
            bp.append((w[0], b[0], w[1], b[1]))
        x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(dev, torch.bfloat16)
        with torch.no_grad():
            want = resblock_stage_plain(x, bp, KS, DILS).float()
            scale = want.abs().max().item()
            for bm, wn, threads in TILES[bn]:
                force_bf16_tile(bn, bm, wn, threads)
                try:
                    plan = bf16_launch_plan(B, T, C, 11, 5)
                    got = fused_resblock_stage(x, bp, KS, DILS)
                    torch.cuda.synchronize()
                    err = (got.float() - want).abs().max().item()
                    ms = _time_ms(lambda: fused_resblock_stage(x, bp, KS, DILS))
                finally:
                    force_bf16_tile(bn)
                good = bool(torch.isfinite(got).all()) and err <= 3e-2 * max(scale, 1.0)
                ok &= good
                emit(stage=si, shape=[B, T, C], bm=bm, bn=bn, warp_n=wn, threads=threads, ms=ms,
                     max_abs_err=err,
                     out_scale=scale, ok=good, plan_k11_d5=plan, card=smi)
                if good and (si not in best or ms < best[si]["ms"]):
                    best[si] = {"bm": bm, "warp_n": wn, "threads": threads, "ms": ms}
            default = bf16_launch_plan(B, T, C, 11, 5)
            emit(stage=si, shape=[B, T, C], default_plan_k11_d5=default,
                 default_ms=_time_ms(lambda: fused_resblock_stage(x, bp, KS, DILS)), card=smi)
            pair_ms = {}
            for j, k in ((0, 3), (2, 11)):  # the k = 3 and k = 11 branches, dilation 1
                w1, b1, w2, b2 = bp[j]
                pair = [(w1[:1], b1[:1], w2[:1], b2[:1])]
                pair_ms[k] = _time_ms(lambda: fused_resblock_stage(x, pair, (k,), (1,)), iters=20)
            tap_flops = 2 * (11 - 3) * 2.0 * B * T * C * C  # 2 convs x 8 taps more
            emit(stage=si, shape=[B, T, C], pair_ms=pair_ms,
                 tap_tflops=tap_flops / ((pair_ms[11] - pair_ms[3]) * 1e-3) / 1e12, card=smi)
    emit(summary="fastest tile per stage", best=best, all_correct=ok, card=smi)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
