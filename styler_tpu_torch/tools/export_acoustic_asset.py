"""Export an acoustic model trained by the port to a committable asset
(counterpart of ``tools/export_acoustic_asset.py``).

Reads the trainer's ``step_<N>.pt`` (``python -m styler_tpu_torch.train``),
or the latest one in its checkpoint directory, where the JAX tool reads an
orbax step directory, and writes one compressed ``.npz`` of float16 leaves
(``core/checkpoint.py:save_acoustic_npz``), the layout of the committed
``assets/acoustic/styler_gen.npz``, which ``load_synthesizer``, the CLIs'
``--ckpt`` and the JAX package's ``load_acoustic_npz`` read.

Usage:
  python -m styler_tpu_torch.tools.export_acoustic_asset \\
      --ckpt ckpt/step_4000.pt --out assets/acoustic/styler_gen.npz
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m styler_tpu_torch.tools.export_acoustic_asset",
                                 description="Export a trained acoustic model to an f16 .npz.")
    ap.add_argument("--ckpt", required=True,
                    help="the trainer's step_<N>.pt, or its checkpoint dir (latest step)")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    from styler_tpu_torch.core.checkpoint import (
        flatten_tree,
        load_acoustic_npz,
        load_trained_checkpoint,
        save_acoustic_npz,
    )
    from styler_tpu_torch.core.config import default_config

    params, stats, step = load_trained_checkpoint(args.ckpt, default_config())
    save_acoustic_npz(args.out, params, stats)
    params, stats = load_acoustic_npz(args.out)  # round-trip sanity
    n = sum(v.size for v in flatten_tree(params).values())
    n_stats = sum(v.size for v in flatten_tree(stats).values())
    mb = os.path.getsize(args.out) / 1e6
    print(f"wrote {args.out}: step {step}, {n / 1e6:.2f} M params "
          f"(+{n_stats} batch-stat scalars), {mb:.1f} MB (f16 compressed)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
