"""Noam-scheduled Adam with a global-norm clip (counterpart of
``styler_tpu/train/optimizer.py``; reference optimizer.py:4-32).

lr(step) = d_model^-0.5 * min(step^-0.5, warmup^-1.5 * step) with the
reference's 1-indexed steps: the first update uses lr(1). Adam betas
(0.9, 0.98), eps 1e-9, no weight decay; the clip scales the gradients by
``clip / max(norm, clip)``, optax's form (``clip_grad_norm_`` adds 1e-6
to the norm instead).
"""

from __future__ import annotations

from typing import Iterable, List

import torch

from styler_tpu_torch.core.config import Config


def noam_schedule(d_model: int, warmup_steps: int):
    """lr as a function of the 1-indexed step."""
    init_lr = float(d_model) ** -0.5

    def schedule(step: int) -> float:
        step = float(step)
        return init_lr * min(step ** -0.5, float(warmup_steps) ** -1.5 * step)

    return schedule


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place by max_norm / max(norm, max_norm); returns
    the global norm before the clip (a tensor: no host round trip)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)
    return norm


class NoamAdam:
    """Clip -> Adam at the Noam rate of the update's 1-indexed step."""

    def __init__(self, params: Iterable[torch.nn.Parameter], config: Config):
        self.params = list(params)
        self.schedule = noam_schedule(config.decoder_hidden, config.n_warm_up_step)
        self.clip = config.grad_clip_thresh
        self.adam = torch.optim.Adam(
            self.params, lr=self.schedule(1), betas=tuple(config.betas), eps=config.eps,
            weight_decay=config.weight_decay,
        )

    def update(self, step: int) -> torch.Tensor:
        """Apply the gradients now on the parameters as update number
        ``step`` (1-indexed). Returns the global gradient norm before the
        clip. A parameter without a gradient is an error."""
        missing = [i for i, p in enumerate(self.params) if p.grad is None]
        if missing:
            raise RuntimeError(f"{len(missing)} parameters have no gradient")
        norm = clip_by_global_norm([p.grad for p in self.params], self.clip)
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(step)
        self.adam.step()
        return norm

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)
