"""Train state: the model in train mode, its optimizer and the step
counter (counterpart of ``styler_tpu/train/state.py``).

``create_train_state`` initialises like flax does for the reference's
modules, from an explicit generator: Dense and Conv kernels lecun-normal
(truncated normal of variance 1/fan_in), their biases zero; ``nn.Embed``
normal of variance 1/features; the phoneme table normal(0, 1); the LSTMs
uniform in +-1/sqrt(H); norm scales 1 and biases 0; running statistics
0 / 1. The two frameworks' random streams differ, so only the
distributions agree; ``train_state_from_flax`` loads a flax tree exactly.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn as nn

from styler_tpu_torch.core.config import Config
from styler_tpu_torch.core.convert import load_flax_tree
from styler_tpu_torch.core.device import resolve_device
from styler_tpu_torch.models import STYLER
from styler_tpu_torch.models.audio_encoder import BiLSTM
from styler_tpu_torch.train.optimizer import NoamAdam

#: stddev of a standard normal truncated to (-2, 2), as jax's
#: variance_scaling divides by it
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass
class TrainState:
    """Updated in place by ``train_step`` (PyTorch keeps parameters and
    optimizer moments where they are)."""

    config: Config
    model: STYLER
    optimizer: NoamAdam
    step: int = 0
    #: global gradient norm of the last update, before the clip
    grad_norm: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter and running statistic of ``model`` in
    place. Values are drawn on the generator's device and then copied, so
    one CPU generator gives the same weights on every device."""
    gdev = generator.device

    def lecun(p: torch.Tensor, fan_in: int) -> None:
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        t = torch.empty(p.shape, device=gdev)
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
        p.copy_(t)

    def normal(p: torch.Tensor, std: float) -> None:
        p.copy_(torch.randn(p.shape, generator=generator, device=gdev) * std)

    def uniform(p: torch.Tensor, bound: float) -> None:
        p.copy_((torch.rand(p.shape, generator=generator, device=gdev) * 2 - 1) * bound)

    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, nn.Linear):
                lecun(m.weight, m.in_features)
                m.bias.zero_()
            elif isinstance(m, nn.Conv1d):
                lecun(m.weight, m.in_channels * m.kernel_size[0])
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                normal(m.weight, math.sqrt(1.0 / m.embedding_dim))
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, nn.BatchNorm1d):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
            elif isinstance(m, BiLSTM):
                for p in m.parameters(recurse=False):
                    uniform(p, 1.0 / math.sqrt(p.shape[0] // 4))
            else:
                for pname, p in m.named_parameters(recurse=False):
                    if pname != "src_word_emb":
                        raise NotImplementedError(f"no initialiser for {name}.{pname}")
                    normal(p, 1.0)


def _state(config: Config, model: STYLER, device) -> TrainState:
    if config.compute_dtype != "float32":
        raise NotImplementedError(
            "training with compute_dtype='bfloat16' is a later slice of the port "
            "(ROADMAP.md, Queue 1 [12]); the bfloat16 acoustic model serves only"
        )
    if config.acc_steps > 1:
        raise NotImplementedError(
            "gradient accumulation (acc_steps > 1) is not ported yet (ROADMAP.md)"
        )
    model.to(resolve_device(device)).train()
    return TrainState(config, model, NoamAdam(model.parameters(), config))


def create_train_state(
    config: Config, generator: torch.Generator, device=None
) -> TrainState:
    """A freshly initialised model in train mode with its optimizer, on
    CUDA unless ``device="cpu"`` (raises without a card)."""
    model = STYLER(config)
    init_like_flax(model, generator)
    return _state(config, model, device)


def train_state_from_flax(
    config: Config, params: dict, batch_stats: dict, device=None
) -> TrainState:
    """Train state from a flax (params, batch_stats) tree, e.g. the
    committed asset read by ``core.checkpoint.load_acoustic_npz``."""
    model = STYLER(config)
    load_flax_tree(model, params, batch_stats)
    return _state(config, model, device)
