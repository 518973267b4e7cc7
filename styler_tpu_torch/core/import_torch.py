"""Reference PyTorch vocoder checkpoints -> flax-style weight trees.

Counterpart of ``styler_tpu/core/import_torch.py`` (``strip_module_prefix``,
the weight-norm fold and ``import_hifigan_state``) and of the vocoder
loaders of ``styler_tpu/core/checkpoint.py``: the reference's universal
HiFi-GAN ``generator_universal.pth.tar`` holds ``['generator']``, a state
dict with ``weight_g`` / ``weight_v`` pairs (the reference removes weight
norm before use). The fold gives plain weights, and the result is the
flax-layout tree that ``core/convert.py:load_flax_tree`` consumes, so every
leaf is used exactly once:

    Conv1d  [out, in, k]  -> kernel [k, in, out]
    ConvT1d [in, out, k]  -> kernel [k, in, out], k axis flipped
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from styler_tpu_torch.vocoder.hifigan import HiFiGANConfig


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def strip_module_prefix(state: Dict) -> Dict:
    """Drop DataParallel's ``module.`` prefix from every key."""
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in state.items()}


def fold_weight_norm(sd: Dict, key: str) -> np.ndarray:
    """w = g * v / ||v||, the norm over every axis but 0; a plain
    ``weight`` is taken as it is."""
    if f"{key}.weight" in sd:
        return _np(sd[f"{key}.weight"])
    g = _np(sd[f"{key}.weight_g"])
    v = _np(sd[f"{key}.weight_v"])
    norm_v = np.sqrt((v ** 2).sum(axis=tuple(range(1, v.ndim)), keepdims=True))
    return g * v / norm_v


def _conv1d(sd: Dict, key: str) -> Dict[str, np.ndarray]:
    return {"kernel": fold_weight_norm(sd, key).transpose(2, 1, 0).copy(),
            "bias": _np(sd[f"{key}.bias"])}


def _conv_transpose1d(sd: Dict, key: str) -> Dict[str, np.ndarray]:
    # a transposed conv is a conv over the stride-dilated input with the
    # kernel flipped: [in, out, k] -> [k, in, out], k reversed
    return {"kernel": fold_weight_norm(sd, key).transpose(2, 0, 1)[::-1].copy(),
            "bias": _np(sd[f"{key}.bias"])}


def import_hifigan_state(torch_state: Dict, config: Optional[HiFiGANConfig] = None) -> Dict:
    """Reference ``generator`` state dict -> flax-style params tree of the
    HiFi-GAN generator (``conv_pre``, ``ups_{i}``, ``resblocks_{i}_{j}``
    with ``convs{1,2}_{c}``, ``conv_post``)."""
    cfg = config or HiFiGANConfig()
    sd = strip_module_prefix(torch_state)
    params = {"conv_pre": _conv1d(sd, "conv_pre"), "conv_post": _conv1d(sd, "conv_post")}
    n_k = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        params[f"ups_{i}"] = _conv_transpose1d(sd, f"ups.{i}")
        for j in range(n_k):
            flat = i * n_k + j
            block = {}
            for c in range(len(cfg.resblock_dilation_sizes[j])):
                block[f"convs1_{c}"] = _conv1d(sd, f"resblocks.{flat}.convs1.{c}")
                block[f"convs2_{c}"] = _conv1d(sd, f"resblocks.{flat}.convs2.{c}")
            params[f"resblocks_{i}_{j}"] = block
    return params


def load_reference_hifigan(path: str, config: Optional[HiFiGANConfig] = None) -> Dict:
    """``generator_universal.pth.tar`` -> flax-style params tree."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt["generator"] if "generator" in ckpt else ckpt
    return import_hifigan_state(state, config)


def load_reference_vocoder(path: str, name: str = "HiFi-GAN") -> Dict:
    """A reference torch vocoder checkpoint -> flax-style params, keyed on
    the reference's ``hp.vocoder`` names."""
    if name == "HiFi-GAN":
        return load_reference_hifigan(path)
    if name in ("MelGAN", "WaveGlow"):
        raise NotImplementedError(
            f"importing a reference {name} checkpoint is a later slice of the port "
            "(ROADMAP.md, Queue 1 item 15)"
        )
    raise ValueError(f"no reference torch checkpoint format for vocoder {name!r}")
