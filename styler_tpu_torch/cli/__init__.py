"""Command-line entry points of the port, on the card unless ``--device
cpu``:

- ``python -m styler_tpu_torch.cli.synthesize``, the flags of
  ``cli/synthesize.py``;
- ``python -m styler_tpu_torch.cli.serve``, the JSON-lines server of
  ``cli/serve.py`` (``--bundle DIR`` serves an exported bundle);
- ``python -m styler_tpu_torch.cli.export``, the bundle export of
  ``cli/export.py``.

This module holds the flags and checks they share. It imports nothing
beyond the standard library, because the server points ``sys.stdout`` at
stderr before the port (and torch) is imported.
"""

from __future__ import annotations

import argparse

CKPT_HELP = ("acoustic weights: a .npz asset (default: the committed trained asset), the "
             "trainer's step_<N>.pt or its checkpoint dir (latest step), a reference "
             "checkpoint_<step>.pth.tar, or 'random'; an orbax dir raises")


def add_model_flags(parser: argparse.ArgumentParser) -> None:
    """The weight, reference, bucket and device flags of both entry points."""
    parser.add_argument("--ckpt", type=str, default=None, help=CKPT_HELP)
    parser.add_argument("--vocoder_ckpt", type=str, default=None,
                        help=".npz asset or reference generator_universal.pth.tar")
    parser.add_argument("--ref_audio_dir", type=str, default=None)
    parser.add_argument("--ref_tg_dir", type=str, default=None)
    parser.add_argument("--version", type=str, default="")
    parser.add_argument("--vocoder", type=str, default=None,
                        choices=["HiFi-GAN", "MelGAN", "WaveGlow", "iSTFTNet"],
                        help="vocoder family; MelGAN and WaveGlow raise")
    parser.add_argument("--bf16", action="store_true",
                        help="mixed-precision acoustic model (bfloat16 convs and matmuls at "
                             "the JAX package's dtype= sites; norms, LSTMs and the mel "
                             "projection float32)")
    parser.add_argument("--src_buckets", type=int, nargs="+", default=None,
                        help="override phoneme-axis shape buckets")
    parser.add_argument("--mel_buckets", type=int, nargs="+", default=None,
                        help="override mel-frame-axis shape buckets")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a CUDA device) or cpu")


def refuse_unported(args: argparse.Namespace) -> None:
    """Raise ``NotImplementedError`` naming its ROADMAP item for a vocoder
    the port does not carry yet (``--ckpt`` forms: ``load_synthesizer``)."""
    if args.vocoder in ("MelGAN", "WaveGlow"):
        raise NotImplementedError(
            f"--vocoder {args.vocoder}: a later slice of the port (ROADMAP.md, Queue 1 [15])")


def config_from_args(args: argparse.Namespace):
    """``default_config()`` with the flags' version, ``--bf16``, reference
    dirs and bucket overrides."""
    from styler_tpu_torch.core.config import default_config

    cfg = default_config().replace(version=args.version)
    if args.bf16:
        cfg = cfg.replace(compute_dtype="bfloat16")
    if args.ref_audio_dir:
        cfg = cfg.replace(ref_audio_dir=args.ref_audio_dir)
    if args.ref_tg_dir:
        cfg = cfg.replace(ref_tg_dir=args.ref_tg_dir)
    if args.src_buckets:
        cfg = cfg.replace(src_buckets=tuple(args.src_buckets))
    if args.mel_buckets:
        cfg = cfg.replace(mel_buckets=tuple(args.mel_buckets))
    return cfg
