"""The acoustic model's weight forms, as flax-style trees.

Copies of ``save_acoustic_npz`` / ``load_acoustic_npz`` /
``load_vocoder_npz``, their tree helpers and ``load_reference_checkpoint``
from ``styler_tpu/core/checkpoint.py``: an asset is ONE compressed ``.npz``
of float16 leaves under flat ``a/b/c`` keys, with PostNet batch
statistics under ``__stats__/``. The trees are nested dicts of float32
numpy arrays; ``core/convert.py`` loads them into the port's modules.

The port's trainer writes ``<ckpt_dir>/step_<N>.pt`` (``torch.save`` of
the model's state dict, the optimizer's and the step);
``load_trained_checkpoint`` reads the model's part of such a file, or of
the latest one in a directory, where the JAX package reads an orbax step
directory.
"""

from __future__ import annotations

import glob
import os
import re
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


def save_acoustic_npz(path: str, params: dict, batch_stats: Optional[dict]) -> None:
    """(params, batch_stats) flax trees -> ONE compressed .npz of float16
    leaves, batch statistics under ``__stats__/`` (the committed asset's
    layout, which the JAX ``load_acoustic_npz`` reads)."""
    flat = {k: np.asarray(v).astype(np.float16) for k, v in flatten_tree(params).items()}
    flat.update({f"__stats__/{k}": np.asarray(v).astype(np.float16)
                 for k, v in flatten_tree(batch_stats or {}).items()})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **flat)


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


def checkpoint_file(ckpt_dir: str, step: int) -> str:
    """The trainer's checkpoint of ``step`` under ``ckpt_dir``."""
    return os.path.join(ckpt_dir, f"step_{step}.pt")


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest N of the ``step_<N>.pt`` files under ``ckpt_dir``, or None."""
    steps = [int(m.group(1)) for f in glob.glob(os.path.join(ckpt_dir, "step_*.pt"))
             if (m := re.search(r"step_(\d+)\.pt$", f))]
    return max(steps) if steps else None


def load_trained_checkpoint(path: str, config) -> Tuple[dict, dict, int]:
    """The trainer's ``step_<N>.pt``, or the latest one in a checkpoint
    directory -> (params, batch_stats) flax trees and the step. Only the
    ``"model"`` state dict is read, into ``STYLER(config)``, whose widths it
    must fit."""
    import torch

    from styler_tpu_torch.core.convert import to_flax_tree
    from styler_tpu_torch.models import STYLER

    if os.path.isdir(path):
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no step_<N>.pt checkpoint under {path}")
        path = checkpoint_file(path, step)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    model = STYLER(config)
    model.load_state_dict(blob["model"])
    return (*to_flax_tree(model), int(blob["step"]))


def load_reference_checkpoint(path: str, config) -> Tuple[dict, dict]:
    """The reference's ``checkpoint_<step>.pth.tar`` -> (params,
    batch_stats) flax trees: its ``["model"]`` if present, else the whole
    dict, through ``core/import_torch.py:import_styler_state``."""
    import torch

    from styler_tpu_torch.core.import_torch import import_styler_state

    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state = ckpt["model"] if "model" in ckpt else ckpt
    return import_styler_state(state, config)
