"""DeepSpeaker ResCNN speaker embedder in PyTorch (inference), the
counterpart of ``styler_tpu/speaker/rescnn.py``.

Parity target: reference deepspeaker/conv_models.py:22-135 (TF-Keras):
4 stages of [Conv2D k5 s2 'same' -> BN -> clipped-ReLU(0,20) -> 3 identity
blocks], reshape [B, T/16, 4*512], temporal mean pool, Dense(512),
L2-normalize. Weights import from the Keras ``.h5`` checkpoint via
``import_deepspeaker_h5`` as a flax-style tree, which
``core/convert.py:load_flax_tree`` loads.

Layout: the JAX model takes NHWC fbank images [B, T, 64, 1] (H = time);
the port takes NCHW [B, 1, T, 64]. ``ResCNN`` is parametrised by its
stages, so the smaller trained ``SpeakerEncoder`` (``encoder.py``) is the
same module with other widths.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from styler_tpu_torch.speaker.features import NUM_FBANKS

#: Keras BatchNormalization's default epsilon (flax modules set it too),
#: not torch's 1e-5
BN_EPS = 1e-3


def clipped_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 20.0)


class SameConv2d(nn.Conv2d):
    """``nn.Conv2d`` with flax / Keras ``'SAME'`` padding: out = ceil(in /
    stride), total pad max((out - 1)·stride + k - in, 0), ``total // 2`` on
    the low side and the rest on the high side. For the 5x5 stride-2 convs
    that is (1, 2) on an even size and (2, 2) on an odd one, which no
    symmetric ``padding=`` gives, so the input is padded explicitly."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []  # F.pad order: last dimension first
        for n, k, s in zip(reversed(x.shape[2:]), reversed(self.kernel_size), reversed(self.stride)):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


class IdentityBlock(nn.Module):
    """conv 3x3 -> BN -> clipped-ReLU, twice, then clipped-ReLU(x + input)."""

    def __init__(self, filters: int, kernel: int = 3):
        super().__init__()
        self.conv_2a = SameConv2d(filters, filters, kernel)
        self.bn_2a = nn.BatchNorm2d(filters, eps=BN_EPS)
        self.conv_2b = SameConv2d(filters, filters, kernel)
        self.bn_2b = nn.BatchNorm2d(filters, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = clipped_relu(self.bn_2a(self.conv_2a(x)))
        h = clipped_relu(self.bn_2b(self.conv_2b(h)))
        return clipped_relu(h + x)


class ConvResStage(nn.Module):
    """conv 5x5 stride 2 -> BN -> clipped-ReLU, then ``n_blocks`` identity
    blocks (``res_0`` ...)."""

    def __init__(self, in_ch: int, filters: int, n_blocks: int = 3):
        super().__init__()
        self.conv = SameConv2d(in_ch, filters, 5, stride=2)
        self.bn = nn.BatchNorm2d(filters, eps=BN_EPS)
        self.blocks = [f"res_{i}" for i in range(n_blocks)]
        for name in self.blocks:
            self.add_module(name, IdentityBlock(filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = clipped_relu(self.bn(self.conv(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x


class ResCNN(nn.Module):
    """[B, 1, T, 64] fbank images -> [B, embed_dim] L2-normalized
    embeddings; stages ``stage_1`` ... of ``filters`` channels."""

    def __init__(self, filters: Tuple[int, ...] = (64, 128, 256, 512), n_blocks: int = 3,
                 embed_dim: int = 512, n_fbanks: int = NUM_FBANKS):
        super().__init__()
        self.stages = [f"stage_{i}" for i in range(1, len(filters) + 1)]
        in_ch, width = 1, n_fbanks
        for name, f in zip(self.stages, filters):
            self.add_module(name, ConvResStage(in_ch, f, n_blocks))
            in_ch, width = f, -(-width // 2)
        self.affine = nn.Linear(width * in_ch, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.stages:
            x = getattr(self, name)(x)
        # flax flattens [B, T, W, C] with C fastest: NCHW -> NHWC first
        x = x.permute(0, 2, 3, 1)
        B, T, W, C = x.shape
        x = self.affine(x.reshape(B, T, W * C).mean(dim=1))
        return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


# ----------------------------------------------------------------------
# Keras .h5 importer
# ----------------------------------------------------------------------


def _h5_weights(h5group):
    """Extract {name: array} from a keras layer group."""
    out = {}

    def visit(name, obj):
        if hasattr(obj, "shape"):
            out[name] = np.asarray(obj)

    h5group.visititems(visit)
    return out


def import_deepspeaker_h5(h5_path: str) -> Dict:
    """Convert the Keras ResCNN checkpoint to a flax-style
    ``{"params": ..., "batch_stats": ...}`` tree of numpy arrays (the
    JAX importer's output; ``h5py`` is imported here, on use).

    Keras layer names (conv_models.py): conv{f}-s / conv{f}-s_bn,
    res{stage}_{block}_branch_2a / _2a_bn / _2b / _2b_bn, affine.
    Keras Conv2D kernels are [kh, kw, in, out], the flax layout.
    """
    import h5py

    params: Dict = {}
    stats: Dict = {}
    with h5py.File(h5_path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def layer_arrays(name):
            return _h5_weights(root[name])

        def pick(w, suffix):
            return next(v for k, v in w.items() if k.endswith(suffix))

        def conv(name):
            w = layer_arrays(name)
            return {"kernel": pick(w, "kernel:0"), "bias": pick(w, "bias:0")}

        def bn(name):
            w = layer_arrays(name)
            return (
                {"scale": pick(w, "gamma:0"), "bias": pick(w, "beta:0")},
                {"mean": pick(w, "moving_mean:0"), "var": pick(w, "moving_variance:0")},
            )

        for stage, filters in enumerate((64, 128, 256, 512), start=1):
            sp, ss = {}, {}
            sp["conv"] = conv(f"conv{filters}-s")
            sp["bn"], ss["bn"] = bn(f"conv{filters}-s_bn")
            for block in range(3):
                bp, bs = {}, {}
                base = f"res{stage}_{block}_branch"
                bp["conv_2a"] = conv(f"{base}_2a")
                bp["bn_2a"], bs["bn_2a"] = bn(f"{base}_2a_bn")
                bp["conv_2b"] = conv(f"{base}_2b")
                bp["bn_2b"], bs["bn_2b"] = bn(f"{base}_2b_bn")
                sp[f"res_{block}"] = bp
                ss[f"res_{block}"] = bs
            params[f"stage_{stage}"] = sp
            stats[f"stage_{stage}"] = ss
        params["affine"] = conv("affine")
    return {"params": params, "batch_stats": stats}
