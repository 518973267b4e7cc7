"""Reference PyTorch checkpoints -> flax-style weight trees.

Counterpart of ``styler_tpu/core/import_torch.py`` (``strip_module_prefix``,
``import_styler_state``, the weight-norm fold and ``import_hifigan_state``)
and of the vocoder loaders of ``styler_tpu/core/checkpoint.py``:

- the STYLER acoustic model: the reference's ``checkpoint_<step>.pth.tar``
  holds ``['model']``, a DataParallel state dict (``module.`` prefix);
- the universal HiFi-GAN ``generator_universal.pth.tar`` holds
  ``['generator']``, a state dict with ``weight_g`` / ``weight_v`` pairs
  (the reference removes weight norm before use); the fold gives plain
  weights.

The results are the flax-layout trees that ``core/convert.py:load_flax_tree``
consumes, so every leaf is used exactly once:

    Linear  [out, in]     -> kernel [in, out]
    Conv1d  [out, in, k]  -> kernel [k, in, out]
    ConvT1d [in, out, k]  -> kernel [k, in, out], k axis flipped
    Embedding, LSTM (gate order kept), Layer/Group/BatchNorm: as they are
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from styler_tpu_torch.vocoder.hifigan import HiFiGANConfig


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy()


def strip_module_prefix(state: Dict) -> Dict:
    """Drop DataParallel's ``module.`` prefix from every key."""
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in state.items()}


def _linear(sd: Dict, key: str) -> Dict[str, np.ndarray]:
    return {"kernel": _np(sd[f"{key}.weight"]).T, "bias": _np(sd[f"{key}.bias"])}


def _norm(sd: Dict, key: str) -> Dict[str, np.ndarray]:
    """LayerNorm / GroupNorm / BatchNorm affine parameters."""
    return {"scale": _np(sd[f"{key}.weight"]), "bias": _np(sd[f"{key}.bias"])}


def _lstm(sd: Dict, key: str, num_layers: int = 2) -> Dict[str, np.ndarray]:
    """``nn.LSTM`` -> ``l{layer}_{fwd|bwd}_{w_ih,w_hh,b_ih,b_hh}``, torch's
    layout and gate order (i, f, g, o) kept."""
    out = {}
    for layer in range(num_layers):
        for direction, suffix in (("fwd", ""), ("bwd", "_reverse")):
            for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                 ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                out[f"l{layer}_{direction}_{ours}"] = _np(sd[f"{key}.{theirs}_l{layer}{suffix}"])
    return out


def _channel_up(sd: Dict, key: str) -> Dict:
    """Sequential(Linear, ReLU, Linear, ReLU) -> ChannelUp fc1 / fc2."""
    return {"fc1": _linear(sd, f"{key}.0"), "fc2": _linear(sd, f"{key}.2")}


def _fft_block(sd: Dict, key: str) -> Dict:
    attn, ffn = f"{key}.slf_attn", f"{key}.pos_ffn"
    return {
        "slf_attn": {**{n: _linear(sd, f"{attn}.{n}") for n in ("w_qs", "w_ks", "w_vs", "fc")},
                     "layer_norm": _norm(sd, f"{attn}.layer_norm")},
        "pos_ffn": {"w_1": _conv1d(sd, f"{ffn}.w_1"), "w_2": _conv1d(sd, f"{ffn}.w_2"),
                    "layer_norm": _norm(sd, f"{ffn}.layer_norm")},
    }


def _style_predictor(sd: Dict, key: str) -> Dict:
    conv = f"{key}.conv_layer"
    return {
        "conv1d_1": _conv1d(sd, f"{conv}.conv1d_1.conv"),
        "layer_norm_1": _norm(sd, f"{conv}.layer_norm_1"),
        "conv1d_2": _conv1d(sd, f"{conv}.conv1d_2.conv"),
        "layer_norm_2": _norm(sd, f"{conv}.layer_norm_2"),
        "linear_layer": _linear(sd, f"{key}.linear_layer"),
    }


def _aug_classifier(sd: Dict, key: str) -> Dict:
    return {"d_fc1": _linear(sd, f"{key}.classifier.d_fc1"),
            "d_bn1": _norm(sd, f"{key}.classifier.d_bn1"),
            "d_fc2": _linear(sd, f"{key}.classifier.d_fc2")}


def _conv_branch(sd: Dict, key: str, n_layers: int = 3) -> Dict:
    out = {}
    for i in range(n_layers):
        out[f"conv_{i}"] = _conv1d(sd, f"{key}.{i}.0.conv")
        out[f"gn_{i}"] = _norm(sd, f"{key}.{i}.1")
    return out


def import_styler_state(torch_state: Dict, config) -> Tuple[Dict, Dict]:
    """Reference STYLER state dict -> (params, batch_stats) flax trees.
    ``pitch_norm_linear`` (reference modules.py:254-257) is never called in
    any forward, and is left out as the JAX importer leaves it out."""
    sd = strip_module_prefix(torch_state)
    sm = "style_modeling"
    se = f"{sm}.style_encoder"
    ae = f"{se}.audio_encoder"

    text_encoder = {"src_word_emb": _np(sd[f"{se}.text_encoder.src_word_emb.weight"])}
    for i in range(config.encoder_layer):
        text_encoder[f"layer_{i}"] = _fft_block(sd, f"{se}.text_encoder.layer_stack.{i}")
    audio_encoder = {}
    for n, branch in enumerate("dper", start=1):
        audio_encoder[f"convs_{branch}"] = _conv_branch(sd, f"{ae}.convolutions_{n}")
        audio_encoder[f"lstm_{branch}"] = _lstm(sd, f"{ae}.lstm_{n}")
    style_modeling = {
        "text_encoder": text_encoder,
        "audio_encoder": audio_encoder,
        "text_linear_down": _linear(sd, f"{se}.text_linear_down.0"),
        "speaker_linear_p": _linear(sd, f"{se}.speaker_linear_p.0"),
        "speaker_linear": _linear(sd, f"{se}.speaker_linear.0"),
        "text_linear_up": _linear(sd, f"{sm}.text_linear_up.0"),
        "pitch_embedding": {"embedding": _np(sd[f"{sm}.pitch_embedding.weight"])},
        "energy_embedding": {"embedding": _np(sd[f"{sm}.energy_embedding.weight"])},
    }
    for f in ("d", "p", "e"):
        style_modeling[f"augmentation_classifier_{f}"] = _aug_classifier(
            sd, f"{sm}.augmentation_classifier_{f}")
    for f in ("duration", "pitch", "energy", "residual"):
        style_modeling[f"{f}_linear"] = _channel_up(sd, f"{sm}.{f}_linear")
    for f in ("duration", "pitch", "energy"):
        style_modeling[f"{f}_predictor"] = _style_predictor(sd, f"{sm}.{f}_predictor")

    decoder = {f"layer_{i}": _fft_block(sd, f"decoder.layer_stack.{i}")
               for i in range(config.decoder_layer)}
    postnet, postnet_stats = {}, {}
    for i in range(5):
        key = f"postnet.convolutions.{i}"
        postnet[f"conv_{i}"] = _conv1d(sd, f"{key}.0.conv")
        postnet[f"bn_{i}"] = _norm(sd, f"{key}.1")
        postnet_stats[f"bn_{i}"] = {"mean": _np(sd[f"{key}.1.running_mean"]),
                                    "var": _np(sd[f"{key}.1.running_var"])}
    params = {"style_modeling": style_modeling, "decoder": decoder,
              "mel_linear": _linear(sd, "mel_linear"), "postnet": postnet}
    return params, {"postnet": postnet_stats}


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
