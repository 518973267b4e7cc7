"""Dropout with an explicit generator.

``torch.nn.functional.dropout`` draws from the global generator. The
port's training path draws every keep-mask from a ``torch.Generator`` the
caller passes down (one per optimizer step, seeded from the run's seed
and the step, as the reference folds the step into its PRNG key), so a
resumed run repeats the masks of an uninterrupted one. ``None`` means no
dropout: the switch is separate from ``nn.Module.train()``, which selects
batch statistics in the PostNet's BatchNorm, as ``deterministic`` and
``train`` are separate in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Zero each element with probability ``rate`` and scale the rest by
    1/(1-rate). The generator must live on x's device."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return x * keep.to(x.dtype) / (1.0 - rate)
