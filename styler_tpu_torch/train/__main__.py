"""``python -m styler_tpu_torch.train``: train the acoustic model."""

from __future__ import annotations

import argparse
import os

from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.train.example import write_example_dataset
from styler_tpu_torch.train.trainer import Trainer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m styler_tpu_torch.train", description=__doc__)
    ap.add_argument("--preprocessed", help="preprocessed base dir (holds <dataset>/train.txt)")
    ap.add_argument("--example_dataset", metavar="DIR",
                    help="train on an example dataset made from --seed under DIR "
                         "(written there first unless DIR already holds one)")
    ap.add_argument("--example_utterances", type=int, default=64)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--restore_step", type=int, default=0,
                    help="checkpoint step to resume from; -1 = latest")
    ap.add_argument("--from_asset", action="store_true",
                    help="start from the committed trained acoustic weights")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--version", default="")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--log_step", type=int, default=None)
    ap.add_argument("--save_step", type=int, default=None)
    ap.add_argument("--ckpt_dir", default=None)
    ap.add_argument("--log_dir", default=None)
    args = ap.parse_args(argv)

    cfg = default_config().replace(version=args.version)
    for key in ("batch_size", "seed", "log_step", "save_step"):
        if getattr(args, key) is not None:
            cfg = cfg.replace(**{key: getattr(args, key)})
    if args.preprocessed:
        cfg = cfg.replace(preprocessed_basedir=args.preprocessed)
    if args.example_dataset:
        cfg = cfg.replace(preprocessed_basedir=os.path.abspath(args.example_dataset))
        if not os.path.exists(os.path.join(cfg.preprocessed_path, "train.txt")):
            cfg = write_example_dataset(
                args.example_dataset, cfg, args.example_utterances, seed=cfg.seed
            )
    trainer = Trainer(cfg, device=args.device, init="asset" if args.from_asset else "fresh",
                      ckpt_dir=args.ckpt_dir, log_dir=args.log_dir)
    print(f"train: {len(trainer.dataset)} utterances, {trainer.steps_in_epoch} batches per "
          f"epoch, device {trainer.device}")
    if args.restore_step:
        trainer.restore(args.restore_step)
        print(f"restored step {trainer.state.step}")
    trainer.fit(args.max_steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
