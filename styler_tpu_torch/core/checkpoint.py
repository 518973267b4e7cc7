"""Reading the committed weight assets (numpy only).

Copies of ``load_acoustic_npz`` / ``load_vocoder_npz`` and their tree
helpers from ``styler_tpu/core/checkpoint.py``: an asset is ONE
compressed ``.npz`` of float16 leaves under flat ``a/b/c`` keys, with
PostNet batch statistics under ``__stats__/``. The returned nested dicts
of float32 numpy arrays are flax-style trees; ``core/convert.py`` loads
them into the port's modules.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: committed trained generator assets, keyed by config.vocoder arch name
_VOCODER_ASSET_FILES = {"iSTFTNet": "istft_gen.npz", "HiFi-GAN": "hifigan_gen.npz"}


def flatten_tree(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_tree(v, key))
        else:
            out[key] = v
    return out


def unflatten_tree(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def load_vocoder_npz(path: str) -> dict:
    """.npz -> f32 flax param tree of a vocoder generator."""
    with np.load(path) as z:
        return unflatten_tree({k: z[k].astype(np.float32) for k in z.files})


def load_acoustic_npz(path: str) -> Tuple[dict, dict]:
    """.npz -> (params, batch_stats) f32 flax trees of the STYLER model."""
    with np.load(path) as z:
        flat = {k: z[k].astype(np.float32) for k in z.files}
    stats = {
        k[len("__stats__/"):]: v
        for k, v in flat.items() if k.startswith("__stats__/")
    }
    params = {k: v for k, v in flat.items() if not k.startswith("__stats__/")}
    return unflatten_tree(params), unflatten_tree(stats)


def default_vocoder_asset(arch: str) -> Optional[str]:
    """Path to the committed trained generator for ``arch``, or None."""
    fname = _VOCODER_ASSET_FILES.get(arch)
    if not fname:
        return None
    path = os.path.join(_REPO, "assets", "vocoder", fname)
    return path if os.path.exists(path) else None


def default_acoustic_asset() -> Optional[str]:
    """Path to the committed trained STYLER acoustic weights, or None."""
    path = os.path.join(_REPO, "assets", "acoustic", "styler_gen.npz")
    return path if os.path.exists(path) else None
