"""Load flax-style weight trees (nested dicts of numpy arrays) into the
port's modules.

Torch module paths mirror the flax names (``a.b.c`` <-> ``a/b/c``), and
each module type knows its own leaves:

- ``nn.Linear``        kernel [in, out]  -> weight [out, in]; bias
- ``nn.Conv1d``        kernel [k, in, out] -> weight [out, in, k]; bias
- ``nn.Conv2d``        kernel [kh, kw, in, out] -> weight [out, in, kh, kw];
                       bias
- ``ConvTranspose1dTorch``  flipped kernel [k, in, out] -> conv_transpose1d
                       weight flip(kernel, 0).permute(1, 2, 0) = [in, out, k]
- ``nn.LayerNorm`` / ``nn.GroupNorm``  scale -> weight; bias
- ``nn.BatchNorm1d`` / ``nn.BatchNorm2d``   scale, bias; running mean/var
                       from the batch-stats tree's ``mean`` / ``var``
- ``nn.Embedding``     embedding -> weight
- ``ResBlock1``        convs{1,2}_{i}/kernel, bias stacked over dilations
                       into w{1,2} [n_dil, k, C, C], b{1,2} [n_dil, C]
- any other module's own parameters (the LSTM's ``l0_fwd_w_ih`` ...,
  torch layout already; ``src_word_emb``) copy as they are.

Every leaf of the tree must be used exactly once and every parameter
and running statistic of the module loaded, else loading raises.

``to_flax_tree`` is the inverse: a module's parameters, or their
gradients, as a flax-style tree under the same names and layouts, so a
gradient can be held against ``jax.grad`` leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch
import torch.nn as nn

from styler_tpu_torch.core.checkpoint import flatten_tree, unflatten_tree
from styler_tpu_torch.vocoder.hifigan import ConvTranspose1dTorch, ResBlock1


class _Leaves:
    def __init__(self, flat: Dict[str, np.ndarray], what: str):
        self.flat = flat
        self.used: Set[str] = set()
        self.what = what

    def take(self, key: str) -> np.ndarray:
        if key not in self.flat:
            raise KeyError(f"{self.what} has no leaf {key!r}")
        if key in self.used:
            raise ValueError(f"{self.what} leaf {key!r} used twice")
        self.used.add(key)
        return self.flat[key]

    def check_all_used(self) -> None:
        unused = sorted(set(self.flat) - self.used)
        if unused:
            raise ValueError(f"{self.what} leaves not loaded: {unused[:8]} ({len(unused)} in all)")


def _set(t: torch.Tensor, value: np.ndarray, key: str) -> None:
    value = np.array(value)  # a writable, contiguous copy
    if tuple(value.shape) != tuple(t.shape):
        raise ValueError(f"{key}: shape {tuple(value.shape)} does not fit {tuple(t.shape)}")
    t.copy_(torch.from_numpy(value).to(t.dtype))


def load_flax_tree(
    module: nn.Module, params: dict, batch_stats: Optional[dict] = None
) -> Tuple[Set[str], Set[str]]:
    """Copy a flax (params, batch_stats) tree into ``module`` in place.
    Returns the sets of params and batch-stats keys used."""
    p = _Leaves(flatten_tree(params), "params")
    s = _Leaves(flatten_tree(batch_stats or {}), "batch_stats")
    with torch.no_grad():
        for name, m in module.named_modules():
            pre = name.replace(".", "/")

            def key(leaf: str, pre=pre) -> str:
                return f"{pre}/{leaf}" if pre else leaf

            def copy(t: torch.Tensor, src: _Leaves, leaf: str, fn=lambda a: a):
                _set(t, fn(src.take(key(leaf))), key(leaf))

            if isinstance(m, nn.Linear):
                copy(m.weight, p, "kernel", lambda a: a.T)
                copy(m.bias, p, "bias")
            elif isinstance(m, nn.Conv1d):
                copy(m.weight, p, "kernel", lambda a: a.transpose(2, 1, 0))
                copy(m.bias, p, "bias")
            elif isinstance(m, nn.Conv2d):
                copy(m.weight, p, "kernel", lambda a: a.transpose(3, 2, 0, 1))
                copy(m.bias, p, "bias")
            elif isinstance(m, ConvTranspose1dTorch):
                copy(m.weight, p, "kernel", lambda a: a[::-1].transpose(1, 2, 0))
                copy(m.bias, p, "bias")
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                copy(m.weight, p, "scale")
                copy(m.bias, p, "bias")
            elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                copy(m.weight, p, "scale")
                copy(m.bias, p, "bias")
                copy(m.running_mean, s, "mean")
                copy(m.running_var, s, "var")
            elif isinstance(m, nn.Embedding):
                copy(m.weight, p, "embedding")
            elif isinstance(m, ResBlock1):
                for g, (w, b) in (("convs1", (m.w1, m.b1)), ("convs2", (m.w2, m.b2))):
                    for i in range(w.shape[0]):
                        copy(w[i], p, f"{g}_{i}/kernel")
                        copy(b[i], p, f"{g}_{i}/bias")
            else:
                for pname, t in m.named_parameters(recurse=False):
                    copy(t, p, pname)
    p.check_all_used()
    s.check_all_used()
    return p.used, s.used


def to_flax_tree(module: nn.Module, grads: bool = False) -> Tuple[dict, dict]:
    """``module`` as flax-style (params, batch_stats) trees of numpy
    arrays: the inverse of ``load_flax_tree``. With ``grads=True`` the
    params tree holds each parameter's ``.grad`` (which must exist)
    instead of its value."""
    params: Dict[str, np.ndarray] = {}
    stats: Dict[str, np.ndarray] = {}

    def value(t: torch.Tensor, name: str) -> torch.Tensor:
        if not grads:
            return t.detach()
        if t.grad is None:
            raise ValueError(f"{name} has no gradient")
        return t.grad

    for name, m in module.named_modules():
        pre = name.replace(".", "/")

        def put(dst: dict, leaf: str, t: torch.Tensor, fn=lambda a: a, pre=pre):
            key = f"{pre}/{leaf}" if pre else leaf
            dst[key] = fn(t).cpu().numpy().copy()

        def par(leaf: str, t: torch.Tensor, fn=lambda a: a, name=name):
            put(params, leaf, value(t, f"{name}.{leaf}"), fn)

        if isinstance(m, nn.Linear):
            par("kernel", m.weight, lambda a: a.t())
            par("bias", m.bias)
        elif isinstance(m, nn.Conv1d):
            par("kernel", m.weight, lambda a: a.permute(2, 1, 0))
            par("bias", m.bias)
        elif isinstance(m, nn.Conv2d):
            par("kernel", m.weight, lambda a: a.permute(2, 3, 1, 0))
            par("bias", m.bias)
        elif isinstance(m, ConvTranspose1dTorch):
            par("kernel", m.weight, lambda a: a.permute(2, 0, 1).flip(0))
            par("bias", m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm1d, nn.BatchNorm2d)):
            par("scale", m.weight)
            par("bias", m.bias)
            if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
                put(stats, "mean", m.running_mean)
                put(stats, "var", m.running_var)
        elif isinstance(m, nn.Embedding):
            par("embedding", m.weight)
        elif isinstance(m, ResBlock1):
            for g, (w, b) in (("convs1", (m.w1, m.b1)), ("convs2", (m.w2, m.b2))):
                wv, bv = value(w, f"{name}.{g}"), value(b, f"{name}.{g}")
                for i in range(w.shape[0]):
                    put(params, f"{g}_{i}/kernel", wv[i])
                    put(params, f"{g}_{i}/bias", bv[i])
        else:
            for pname, t in m.named_parameters(recurse=False):
                par(pname, t)
    return unflatten_tree(params), unflatten_tree(stats)
