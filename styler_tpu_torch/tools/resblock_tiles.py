"""Tile sweep of kernel A (``csrc/resblock.cu``, bf16 mode) or of its int8
form (``csrc/resblock_int8.cu``) on one GPU.

    python -m styler_tpu_torch.tools.resblock_tiles [--int8] [--out FILE]

For every tile the kernel has for the N tile of a stage (BN = 32, 64 or
128 by C), forces that tile, runs the whole resblock stage (3 branches x
3 dilations x 2 convs = 18 launches, kernel sizes 3/7/11, dilations
1/3/5) at the four HiFi-GAN stage shapes of a 2 x 1024-frame mel batch
([2, 8192, 256] .. [2, 262144, 32]; the iSTFTNet path's two stages are
the first two), checks it against the plain version (bf16: 3e-2 of the
output scale; int8: 2^-7 of it, the card tests' bound for a kernel that
picks the same integers) and prints its CUDA-event time with the launch
plan of its largest conv (k = 11, dil = 5); with ``--int8`` a forced tile
that does not fit in shared memory falls back to the usual choice, and
the line says which tile ran. Then, per stage with its usual tile, one
conv pair (a single branch and dilation, 2 launches) at k = 3 and at
k = 11: both move the same bytes, so the difference is 16 taps of
products, and ``tap_tflops`` (bf16) or ``tap_tops`` (int8) is the rate
of the kernel's product loop apart from its loads and epilogue. Inputs
and weights are seeded normals; the kernel's time does not depend on
their values. One JSON line per (stage, tile) and per stage's pairs,
then a summary line; ``--out`` also writes them to a file. Fails without
a CUDA device.
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
    force_int8_tile,
    fused_resblock_stage,
    int8_launch_plan,
    quantize_branch_params,
    resblock_stage_int8,
    resblock_stage_int8_plain,
    resblock_stage_plain,
)

#: the HiFi-GAN stage inputs of the main path (B = 2 mels of 1024 frames)
STAGES = ((2, 8192, 256), (2, 65536, 128), (2, 131072, 64), (2, 262144, 32))
#: (BM, warp width, threads) of every tile per BN, as csrc/resblock.cu's TILES
TILES = {32: ((256, 32, 256), (128, 32, 256)),
         64: ((256, 64, 256), (128, 64, 256)),
         128: ((128, 64, 256), (256, 64, 512), (64, 64, 256))}
#: (BM, threads) of every int8 tile per BN, as csrc/resblock_int8.cu's TILES
INT8_TILES = {32: ((256, 256), (128, 256)),
              64: ((256, 256), (128, 256)),
              128: ((128, 256), (256, 512))}
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
    ap.add_argument("--int8", action="store_true", help="sweep the int8 form's tiles")
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
        if args.int8:
            q = quantize_branch_params(bp)
            run = lambda ks, ds, p=q: resblock_stage_int8(x, p, ks, ds)  # noqa: E731
            plain = lambda: resblock_stage_int8_plain(x, q, KS, DILS)  # noqa: E731
            plan_fn, tol = int8_launch_plan, 2 ** -7
            variants = INT8_TILES[bn]
        else:
            q = bp
            run = lambda ks, ds, p=bp: fused_resblock_stage(x, p, ks, ds)  # noqa: E731
            plain = lambda: resblock_stage_plain(x, bp, KS, DILS)  # noqa: E731
            plan_fn, tol = bf16_launch_plan, 3e-2
            variants = TILES[bn]
        with torch.no_grad():
            want = plain().float()
            scale = want.abs().max().item()
            for v in variants:
                if args.int8:
                    bm, threads = v
                    force_int8_tile(bn, bm, threads)
                    tile = dict(bm=bm, bn=bn, threads=threads)
                else:
                    bm, wn, threads = v
                    force_bf16_tile(bn, bm, wn, threads)
                    tile = dict(bm=bm, bn=bn, warp_n=wn, threads=threads)
                try:
                    plan = plan_fn(B, T, C, 11, 5)
                    if args.int8:  # a forced tile that does not fit falls back
                        tile["ran"] = [*plan["tile"], plan["threads"]]
                    got = run(KS, DILS)
                    torch.cuda.synchronize()
                    err = (got.float() - want).abs().max().item()
                    ms = _time_ms(lambda: run(KS, DILS))
                finally:
                    force_int8_tile(bn) if args.int8 else force_bf16_tile(bn)
                good = bool(torch.isfinite(got).all()) and err <= tol * max(scale, 1.0)
                ok &= good
                emit(stage=si, shape=[B, T, C], **tile, ms=ms, max_abs_err=err,
                     out_scale=scale, ok=good, plan_k11_d5=plan, card=smi)
                if good and (si not in best or ms < best[si]["ms"]):
                    best[si] = {**tile, "ms": ms}
            default = plan_fn(B, T, C, 11, 5)
            emit(stage=si, shape=[B, T, C], default_plan_k11_d5=default,
                 default_ms=_time_ms(lambda: run(KS, DILS)), card=smi)
            pair_ms = {}
            for j, k in ((0, 3), (2, 11)):  # the k = 3 and k = 11 branches, dilation 1
                cut = tuple(t[:1] for t in q[j])
                pair = [type(q[j])(*cut) if args.int8 else cut]
                pair_ms[k] = _time_ms(lambda: run((k,), (1,), pair), iters=20)
            tap_ops = 2 * (11 - 3) * 2.0 * B * T * C * C  # 2 convs x 8 taps more
            rate = tap_ops / ((pair_ms[11] - pair_ms[3]) * 1e-3) / 1e12
            emit(stage=si, shape=[B, T, C], pair_ms=pair_ms,
                 **{"tap_tops" if args.int8 else "tap_tflops": rate}, card=smi)
    emit(summary="fastest tile per stage", form="int8" if args.int8 else "bf16", best=best,
         all_correct=ok, card=smi)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
