"""The acoustic model's training loop (counterpart of the loop of the
reference's ``cli/train.py``): dataset -> state (fresh, or from the
committed trained asset) -> steps with a per-step dropout generator ->
one JSON metrics line per ``log_step`` -> a checkpoint every
``save_step`` and at ``max_steps``; restore with mid-epoch resume.

    python -m styler_tpu_torch.train --example_dataset DIR --max_steps 4

runs on the GPU unless ``--device cpu`` is given, and raises without one.

Resume determinism: a restored step maps to (epoch, offset) on the fixed
per-epoch batch sequence (``batches_per_epoch``) and the dropout
generator of a step is seeded from (config.seed, step) alone, so a
resumed run repeats the batches and the masks of an uninterrupted one.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Callable, Dict, Iterator, Optional

import torch

from styler_tpu_torch.core.checkpoint import (
    checkpoint_file,
    default_acoustic_asset,
    latest_step,
    load_acoustic_npz,
)
from styler_tpu_torch.core.config import Config
from styler_tpu_torch.core.device import resolve_device
from styler_tpu_torch.data.dataset import (
    Dataset,
    batch_iterator,
    batch_to_device,
    batches_per_epoch,
    prefetch,
)
from styler_tpu_torch.train.state import (
    TrainState,
    create_train_state,
    train_state_from_flax,
)
from styler_tpu_torch.train.step import train_step


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of update ``step`` (0-indexed, as the reference folds
    the step counter into its PRNG key): a function of (seed, step) only."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + int(step)) % (2 ** 63))
    return g


def save_checkpoint(ckpt_dir: str, state: TrainState) -> str:
    """Model (parameters and BatchNorm statistics), optimizer moments and
    step in one ``torch.save`` file. Returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = checkpoint_file(ckpt_dir, state.step)
    tmp = f"{path}.tmp"
    torch.save(
        {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
         "step": state.step},
        tmp,
    )
    os.replace(tmp, path)
    return path


def restore_checkpoint(ckpt_dir: str, step: int, state: TrainState) -> TrainState:
    """Load step ``step`` (-1: the latest) into ``state`` in place."""
    if step < 0:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    blob = torch.load(checkpoint_file(ckpt_dir, step), map_location=state.device,
                      weights_only=True)
    state.model.load_state_dict(blob["model"])
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    return state


class Trainer:
    """Dataset, state and loop on one device (CUDA unless ``device="cpu"``).

    ``init``: ``"fresh"`` (flax-like initialisation from ``config.seed``)
    or ``"asset"`` (the committed trained acoustic weights).
    """

    def __init__(self, config: Config, device=None, init: str = "fresh",
                 ckpt_dir: Optional[str] = None, log_dir: Optional[str] = None):
        self.config = config
        self.device = resolve_device(device)
        self.dataset = Dataset(config, "train.txt")
        # the reference drops the last incomplete batch_size^2 pool; keep
        # ragged pools when the corpus is smaller than one, so it trains
        self.drop_last = len(self.dataset) >= config.batch_size ** 2
        self.steps_in_epoch = batches_per_epoch(len(self.dataset), config, self.drop_last)
        if self.steps_in_epoch == 0:
            raise ValueError(
                f"{len(self.dataset)} utterances give no batch of {config.batch_size}"
            )
        if init == "fresh":
            gen = torch.Generator().manual_seed(config.seed)
            self.state = create_train_state(config, gen, self.device)
        elif init == "asset":
            asset = default_acoustic_asset()
            if asset is None:
                raise FileNotFoundError("no committed acoustic asset to start from")
            self.state = train_state_from_flax(config, *load_acoustic_npz(asset), self.device)
        else:
            raise ValueError(f"init must be 'fresh' or 'asset', not {init!r}")
        self.ckpt_dir = ckpt_dir or config.checkpoint_path()
        self.log_dir = log_dir or config.log_path()

    def restore(self, step: int) -> None:
        restore_checkpoint(self.ckpt_dir, step, self.state)

    def batches(self) -> Iterator[Dict[str, torch.Tensor]]:
        """Device batches from the state's step on, epoch after epoch."""
        cfg = self.config
        start_epoch, skip = divmod(self.state.step, self.steps_in_epoch)
        for epoch in range(start_epoch, cfg.epochs):
            it = batch_iterator(self.dataset, cfg, seed=cfg.seed, epoch=epoch,
                                drop_last=self.drop_last)
            if skip:
                it = itertools.islice(it, skip, None)
                skip = 0
            for batch in prefetch(it):
                yield batch_to_device(batch, self.device)

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update with the dropout masks of (config.seed, step)."""
        gen = dropout_generator(self.config.seed, self.state.step, self.device)
        return train_step(self.state, batch, gen, self.config.dat_weight)[1]

    def fit(self, max_steps: Optional[int] = None,
            on_step: Optional[Callable[[TrainState, Dict[str, torch.Tensor]], None]] = None,
            log: Callable[[str], None] = print) -> TrainState:
        """Train until ``max_steps`` (or ``config.epochs`` epochs).
        ``on_step(state, components)`` runs after every update."""
        cfg, state = self.config, self.state
        os.makedirs(self.log_dir, exist_ok=True)
        t_log = time.perf_counter()
        with open(os.path.join(self.log_dir, "train_metrics.jsonl"), "a") as metrics_log:
            for batch in self.batches():
                if max_steps is not None and state.step >= max_steps:
                    break
                components = self.step(batch)
                if on_step is not None:
                    on_step(state, components)
                if state.step == 1 or state.step % cfg.log_step == 0:
                    m = {k: float(v) for k, v in components.items()}  # waits for the device
                    now = time.perf_counter()
                    m.update(step=state.step, epoch=(state.step - 1) // self.steps_in_epoch,
                             sec=round(now - t_log, 3), grad_norm=float(state.grad_norm))
                    t_log = now
                    line = json.dumps(m)
                    log(line)
                    metrics_log.write(line + "\n")
                    metrics_log.flush()
                if state.step % cfg.save_step == 0 or state.step == max_steps:
                    log(f"checkpoint saved: {save_checkpoint(self.ckpt_dir, state)}")
        return state
