"""Train and eval steps (counterpart of ``styler_tpu/train/step.py``).

One optimizer update: teacher-forced forward with Residual Decoding ->
DAT second pass on the augmented inputs -> 10-component loss -> backward
-> global-norm clip -> Noam Adam; the PostNet's BatchNorm statistics move
twice (clean decode, then noisy decode). Nothing here synchronises with
the host: the components come back as tensors on the model's device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from styler_tpu_torch.train.losses import styler_loss
from styler_tpu_torch.train.state import TrainState

#: batch keys consumed by the teacher-forced forward
FORWARD_KEYS = (
    "src_seq",
    "mel_target",
    "mel_aug",
    "p_norm",
    "e_input",
    "src_len",
    "mel_len",
    "d_target",
    "p_target",
    "e_target",
    "speaker_embed",
)


def _loss(model, batch: Dict, dat_weight: float, dropout: Optional[torch.Generator]):
    out = model(
        batch["src_seq"], batch["mel_target"], batch["mel_aug"], batch["p_norm"],
        batch["e_input"], batch["src_len"], batch["mel_len"], batch["mel_target"].shape[1],
        batch["speaker_embed"], d_target=batch["d_target"], p_target=batch["p_target"],
        e_target=batch["e_target"], dropout=dropout,
    )
    dat_aug = model.forward_dat(
        batch["mel_aug"], batch["f0_norm_aug"], batch["e_input_aug"],
        batch["mel_len"], batch["src_len"], out.src_mask,
    )
    return styler_loss(
        out, batch["mel_target"], batch["mel_aug"], batch["log_d_target"],
        batch["p_target"], batch["e_target"], dat_aug, dat_weight,
    )


def compute_gradients(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    dropout: Optional[torch.Generator] = None,
    dat_weight: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """Forward and backward of one step: leaves the loss gradient (before
    the clip) on every parameter's ``.grad``, moves the BatchNorm
    statistics, and returns the 10 components."""
    model = state.model.train()
    for p in state.optimizer.params:
        p.grad = None
    total, components = _loss(model, batch, dat_weight, dropout)
    total.backward()
    return {k: v.detach() for k, v in components.items()}


def train_step(
    state: TrainState,
    batch: Dict[str, torch.Tensor],
    dropout: Optional[torch.Generator] = None,
    dat_weight: float = 1.0,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer update, in place on ``state``. ``batch`` holds the
    ``FORWARD_KEYS`` plus ``log_d_target``, ``f0_norm_aug`` and
    ``e_input_aug`` as tensors on the model's device. ``dropout``: the
    step's generator on that device; ``None`` trains without dropout."""
    components = compute_gradients(state, batch, dropout, dat_weight)
    state.grad_norm = state.optimizer.update(state.step + 1)
    state.step += 1
    return state, components


@torch.no_grad()
def eval_step(
    state: TrainState, batch: Dict[str, torch.Tensor], dat_weight: float = 1.0
) -> Dict[str, torch.Tensor]:
    """Teacher-forced evaluation of the 10 loss components on the running
    BatchNorm statistics (reference evaluate.py:27-142)."""
    model = state.model.eval()
    try:
        return _loss(model, batch, dat_weight, None)[1]
    finally:
        model.train()
