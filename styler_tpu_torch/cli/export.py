"""Export a serving bundle of the port (counterpart of ``cli/export.py``).

Writes ``manifest.json`` and ``weights.npz`` (``core/export.py``); the
server captures one CUDA graph per (batch, src bucket, mel bucket) entry
from them (``python -m styler_tpu_torch.cli.serve --bundle DIR``).

Usage:
  python -m styler_tpu_torch.cli.export --out bundle/ [--ckpt styler_gen.npz] \\
      [--vocoder_ckpt g.npz] [--vocoder iSTFTNet] [--batch 1 8] \\
      [--src_buckets 64 128] [--mel_buckets 512 1024] [--fused] [--device cpu]

``--fused`` is accepted and changes nothing: kernel A is the port's only
vocoder path on the card, so every bundle records ``fused_vocoder: true``.
``--platforms`` names XLA lowering targets and is refused. With
``STYLER_TPU_INT8_VOCODER=1`` a HiFi-GAN bundle records the int8 vocoder
form.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from styler_tpu_torch.cli import CKPT_HELP, refuse_unported


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m styler_tpu_torch.cli.export",
                                     description="Export a serving bundle.")
    parser.add_argument("--ckpt", type=str, default=None, help=CKPT_HELP)
    parser.add_argument("--vocoder_ckpt", type=str, default=None,
                        help=".npz asset or reference generator_universal.pth.tar")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--version", type=str, default="")
    parser.add_argument("--vocoder", type=str, default=None,
                        choices=["HiFi-GAN", "MelGAN", "WaveGlow", "iSTFTNet"],
                        help="vocoder family; MelGAN and WaveGlow raise")
    parser.add_argument("--batch", type=int, nargs="+", default=[1],
                        help="batch sizes to export (e.g. --batch 1 8: interactive requests "
                             "use the 1-entries, batched serve requests one replay of an "
                             "8-entry)")
    parser.add_argument("--src_buckets", type=int, nargs="+", default=None)
    parser.add_argument("--mel_buckets", type=int, nargs="+", default=None)
    parser.add_argument("--platforms", type=str, nargs="+", default=None,
                        help="XLA lowering targets of the JAX package's export: refused here")
    parser.add_argument("--fused", action="store_true",
                        help="accepted; the port's bundles always run kernel A")
    parser.add_argument("--device", type=str, default="cuda",
                        help="where the weights are loaded: cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.platforms:
        parser.error("--platforms names XLA lowering targets of the JAX package's export; a "
                     "bundle of the port holds no program (its CUDA graphs are captured where "
                     "it is served)")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    refuse_unported(args)

    from styler_tpu_torch.core.config import default_config
    from styler_tpu_torch.core.export import save_serving_bundle
    from styler_tpu_torch.synthesis import load_synthesizer

    cfg = default_config().replace(version=args.version)
    if args.src_buckets:
        cfg = cfg.replace(src_buckets=tuple(args.src_buckets))
    if args.mel_buckets:
        cfg = cfg.replace(mel_buckets=tuple(args.mel_buckets))
    synth = load_synthesizer(cfg, args.ckpt, args.vocoder_ckpt, vocoder_arch=args.vocoder,
                             device=args.device)
    t0 = time.perf_counter()
    manifest = save_serving_bundle(synth, args.out, src_buckets=args.src_buckets,
                                   mel_buckets=args.mel_buckets, batch=tuple(args.batch))
    size = sum(os.path.getsize(os.path.join(args.out, f)) for f in os.listdir(args.out))
    print(f"exported {len(manifest['entries'])} entries ({manifest['vocoder']}, "
          f"{manifest['vocoder_form']}) to {args.out} ({size / 1e6:.1f} MB) in "
          f"{time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
