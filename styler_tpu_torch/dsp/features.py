"""Feature normalizations and quantizers.

Counterpart of ``styler_tpu/dsp/features.py``: host (numpy) versions for
reference-feature extraction, torch versions on the model input path.
Semantics match the reference (utils.py:387-429).
"""

from __future__ import annotations

import numpy as np
import torch


# ----------------------------------------------------------------------
# Host-side (numpy)
# ----------------------------------------------------------------------

def speaker_normalization_np(f0: np.ndarray) -> np.ndarray:
    """Speaker-relative f0 normalization (reference utils.py:387-397).

    Note the reference's ``index_nonzero = f0 > -1e10`` selects *every*
    frame (f0 >= 0 always), so the z-score statistics include unvoiced
    zeros; we reproduce that faithfully: z-score / 4, clip to [-1, 1],
    shift to [0, 1].
    """
    f0 = f0.astype(float).copy()
    sel = f0 > -1e10
    mean_f0, std_f0 = np.mean(f0[sel]), np.std(f0[sel])
    f0[sel] = (f0[sel] - mean_f0) / std_f0 / 4.0
    f0[sel] = np.clip(f0[sel], -1, 1)
    f0[sel] = (f0[sel] + 1) / 2.0
    return f0


def f0_normalization_np(f0: np.ndarray) -> np.ndarray:
    """speaker_normalization with a zeros fallback on degenerate inputs
    (reference utils.py:400-407 converts numpy warnings to exceptions)."""
    with np.errstate(all="raise"):
        try:
            std = np.std(f0.astype(float))
            if not np.isfinite(std) or std == 0.0 or f0.size == 0:
                return np.zeros_like(f0, dtype=float)
            return speaker_normalization_np(f0)
        except FloatingPointError:
            return np.zeros_like(f0, dtype=float)


def energy_rescaling_np(energy: np.ndarray, energy_min: float, energy_max: float) -> np.ndarray:
    """Min-max rescale energy to [0, 1] (reference utils.py:410-414)."""
    out = (energy - energy_min) / (energy_max - energy_min)
    return np.clip(out, 0, 1)


# ----------------------------------------------------------------------
# Model input path (torch)
# ----------------------------------------------------------------------

def quantize_one_hot(x: torch.Tensor, num_bins: int = 256) -> torch.Tensor:
    """256-bin one-hot quantizer with an unvoiced/zero bin (reference
    utils.quantize_1D_torch, utils.py:417-429): values in (0, 1] map to bins
    1..256 via round(x*255)+1 (round half to even); values <= 0 map to bin 0.

    x: [..., T]. Returns [..., T, num_bins+1] float32.
    """
    uv = x <= 0
    idx = torch.round(x * (num_bins - 1)).to(torch.int64) + 1
    idx = idx.masked_fill(uv, 0)
    return torch.nn.functional.one_hot(idx, num_bins + 1).to(torch.float32)


def bucketize(x: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """torch.bucketize(x, boundaries, right=False): the first i with
    x <= boundaries[i] (the reference's pitch/energy embedding lookups,
    modules.py:366-382)."""
    return torch.bucketize(x, boundaries, right=False)


def pitch_bin_edges(f0_min: float, f0_max: float, n_bins: int = 256) -> np.ndarray:
    """Log-spaced pitch bin boundaries (reference modules.py:278-279)."""
    return np.exp(np.linspace(np.log(f0_min), np.log(f0_max), n_bins - 1)).astype(np.float32)


def energy_bin_edges(energy_min: float, energy_max: float, n_bins: int = 256) -> np.ndarray:
    """Linear energy bin boundaries (reference modules.py:280-281)."""
    return np.linspace(energy_min, energy_max, n_bins - 1).astype(np.float32)
