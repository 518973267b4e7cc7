"""Synthesis engine: text + reference audio -> mels and waveforms
(counterpart of ``styler_tpu/synthesis.py``: ``ReferenceFeatures``,
``extract_reference_features``, ``Synthesizer.synthesize`` and the weight
resolution of ``load_synthesizer``).

One request: text -> phoneme ids on the host; the STYLER eval forward
(text encoder, audio encoder with the BiLSTM recurrences in kernel B,
predictors, length regulator, one 2B decode + PostNet); one 2B vocoder
pass over the clean and noisy mels, HiFi-GAN or iSTFTNet, whose resblock
stages run kernel A (HiFi-GAN: its int8 form with
``STYLER_TPU_INT8_VOCODER=1``). The reference mel axis pads to its bucket;
the output mel axis is always the largest mel bucket.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional

import numpy as np
import torch

from styler_tpu_torch.core.checkpoint import (
    default_acoustic_asset,
    default_vocoder_asset,
    load_acoustic_npz,
    load_vocoder_npz,
)
from styler_tpu_torch.core.config import Config, bucket_for
from styler_tpu_torch.core.convert import load_flax_tree, to_flax_tree
from styler_tpu_torch.core.device import resolve_device
from styler_tpu_torch.core.import_torch import load_reference_vocoder
from styler_tpu_torch.dsp.features import energy_rescaling_np, f0_normalization_np
from styler_tpu_torch.dsp.mel import MelFrontend
from styler_tpu_torch.dsp.pitch import get_f0, get_f0_noisy
from styler_tpu_torch.models import STYLER
from styler_tpu_torch.textproc import G2p, text_to_sequence, to_phoneme_string
from styler_tpu_torch.vocoder import make_generator

_log = logging.getLogger("styler_tpu_torch.synthesis")


@dataclasses.dataclass
class ReferenceFeatures:
    """Frame-domain features of a style reference audio."""

    mel: np.ndarray  # [M, 80]
    f0_norm: np.ndarray  # [M]
    energy01: np.ndarray  # [M]
    mel_len: int


def extract_reference_features(
    wav: np.ndarray,
    config: Config,
    frontend: MelFrontend,
    duration: Optional[list] = None,
    noisy: bool = False,
) -> ReferenceFeatures:
    """Reference wav (int16-scaled float) -> model inputs
    (reference dataset.py:58-71 + synthesize.py:420-441)."""
    f0 = (get_f0_noisy if noisy else get_f0)(wav, config, duration)
    mel, energy = frontend(np.asarray(wav, dtype=np.float32) / config.max_wav_value)
    total = sum(duration) if duration is not None else mel.shape[1]
    mel = mel.astype(np.float32)[:, :total].T
    energy = energy.astype(np.float32)[:total]
    n = min(len(f0), mel.shape[0], len(energy))
    cap = config.mel_buckets[-1]
    if n > cap:
        _log.warning(
            "reference audio is %d mel frames; trimming to the largest "
            "mel bucket (%d frames, %.1f s) for style extraction",
            n, cap, cap * config.hop_length / config.sampling_rate,
        )
        n = cap
    return ReferenceFeatures(
        mel=mel[:n],
        f0_norm=f0_normalization_np(f0[:n]).astype(np.float32),
        energy01=energy_rescaling_np(
            energy[:n], config.energy_min, config.energy_max
        ).astype(np.float32),
        mel_len=n,
    )


class Synthesizer:
    """The STYLER acoustic model and a HiFi-GAN or iSTFTNet vocoder
    (``config.vocoder``) on one device (CUDA unless ``device="cpu"``).

    ``STYLER_TPU_INT8_VOCODER=1``, read once here as the JAX package does,
    runs HiFi-GAN's resblock stages in kernel A's int8 form (approximate;
    ignored for iSTFTNet)."""

    def __init__(self, config: Config, params: dict, batch_stats: dict,
                 vocoder_params: dict, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.int8_vocoder = os.environ.get("STYLER_TPU_INT8_VOCODER", "0") == "1"
        self.generator = make_generator(config.vocoder, torch.bfloat16,
                                        quantize=self.int8_vocoder)
        load_flax_tree(self.generator, vocoder_params)
        self.generator.to(self.device).eval()
        self.model = STYLER(config)
        load_flax_tree(self.model, params, batch_stats)
        self.model.to(self.device).eval()
        self.frontend = MelFrontend(config, self.device)
        self.g2p = G2p()

    def text_to_ids(self, sentence: str) -> np.ndarray:
        return self._ids_from_phonemes(to_phoneme_string(sentence, self.g2p))

    def _ids_from_phonemes(self, phoneme_str: str) -> np.ndarray:
        return np.asarray(
            text_to_sequence(phoneme_str, list(self.config.text_cleaners)),
            dtype=np.int32,
        )

    def _clamp_ref(self, ref: ReferenceFeatures) -> ReferenceFeatures:
        cap = self.config.mel_buckets[-1]
        if ref.mel_len <= cap:
            return ref
        _log.warning(
            "reference has %d mel frames > largest mel bucket %d; trimming",
            ref.mel_len, cap,
        )
        return ReferenceFeatures(
            mel=ref.mel[:cap], f0_norm=ref.f0_norm[:cap],
            energy01=ref.energy01[:cap], mel_len=cap,
        )

    @torch.no_grad()
    def _forward(self, src_seq, src_len, mel, f0_norm, energy01, mel_len,
                 speaker_embed, d_control, p_control, e_control, max_mel_len):
        out = self.model(
            src_seq, mel, mel, f0_norm, energy01, src_len, mel_len,
            max_mel_len, speaker_embed, d_control, p_control, e_control,
        )
        # one 2B vocoder pass for the clean and the noisy mel
        B = out.mel_postnet.shape[0]
        wavs = self.generator(torch.cat([out.mel_postnet, out.mel_postnet_noisy], dim=0))
        return out, wavs[:B], wavs[B:]

    def synthesize(
        self,
        sentence: str,
        ref: ReferenceFeatures,
        speaker_embed: np.ndarray,
        d_control: float = 1.0,
        p_control: float = 1.0,
        e_control: float = 1.0,
    ) -> Dict:
        """One sentence with one reference -> mels + waveforms + predictions
        (the same keys as the reference's ``synthesize``)."""
        cfg = self.config
        ref = self._clamp_ref(ref)
        ids = self._ids_from_phonemes(to_phoneme_string(sentence, self.g2p))
        if len(ids) > cfg.src_buckets[-1]:
            raise NotImplementedError(
                f"sentence of {len(ids)} phonemes exceeds the largest src bucket "
                f"({cfg.src_buckets[-1]}); chunked synthesis of long sentences is "
                "a later slice (ROADMAP.md)"
            )
        L = bucket_for(len(ids), cfg.src_buckets)
        M_in = bucket_for(ref.mel_len, cfg.mel_buckets)
        M_out = cfg.mel_buckets[-1]

        src_seq = np.zeros((1, L), np.int64)
        src_seq[0, : len(ids)] = ids
        mel = np.zeros((1, M_in, cfg.n_mel_channels), np.float32)
        mel[0, : ref.mel_len] = ref.mel[: ref.mel_len]
        f0 = np.zeros((1, M_in), np.float32)
        f0[0, : ref.mel_len] = ref.f0_norm[: ref.mel_len]
        en = np.zeros((1, M_in), np.float32)
        en[0, : ref.mel_len] = ref.energy01[: ref.mel_len]

        dev = self.device
        out, wav_clean, wav_noisy = self._forward(
            torch.from_numpy(src_seq).to(dev),
            torch.tensor([len(ids)], dtype=torch.int64, device=dev),
            torch.from_numpy(mel).to(dev),
            torch.from_numpy(f0).to(dev),
            torch.from_numpy(en).to(dev),
            torch.tensor([ref.mel_len], dtype=torch.int64, device=dev),
            torch.from_numpy(np.asarray(speaker_embed, np.float32).reshape(1, -1)).to(dev),
            float(d_control), float(p_control), float(e_control),
            M_out,
        )
        mel_len = int(out.mel_len[0])
        n_samples = mel_len * cfg.hop_length
        return {
            "mel": out.mel_postnet[0, :mel_len].cpu().numpy(),
            "mel_noisy": out.mel_postnet_noisy[0, :mel_len].cpu().numpy(),
            "wav": wav_clean[0, :n_samples].cpu().numpy(),
            "wav_noisy": wav_noisy[0, :n_samples].cpu().numpy(),
            "f0": out.p_prediction[0, :mel_len].cpu().numpy(),
            "energy": out.e_prediction[0, :mel_len].cpu().numpy(),
            "duration": out.log_d_prediction[0].cpu().numpy(),
            "mel_len": mel_len,
            "encodings": out.encodings,
            "src_mask": out.src_mask.cpu().numpy(),
        }


def _random_vocoder(config: Config) -> dict:
    """Flax-style params of a generator drawn from an explicit seeded
    ``torch.Generator``: N(0, 0.01) kernels, zero biases (the JAX package's
    ``ConvTranspose1dTorch`` init; its ``nn.Conv`` leaves use lecun-normal
    from a ``jax.random`` key, which no torch generator reproduces, so the
    weights differ from the JAX package's ``"random"`` ones either way)."""
    gen = torch.Generator().manual_seed(config.seed)
    module = make_generator(config.vocoder)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(("b1", "b2", "bias")):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.01)
    return to_flax_tree(module)[0]


def load_synthesizer(
    config: Config,
    ckpt_path: Optional[str] = None,
    vocoder_path: Optional[str] = None,
    vocoder_arch: Optional[str] = None,
    device=None,
) -> Synthesizer:
    """Build a Synthesizer on ``device`` (CUDA unless ``device="cpu"``;
    with no CUDA device and no device given this raises, with no CPU
    fallback).

    Acoustic weights: ``ckpt_path=None`` loads the committed trained asset
    (``assets/acoustic/styler_gen.npz``); an explicit ``.npz`` path loads
    that asset file. Reference ``.pth.tar`` checkpoints, orbax directories
    and ``"random"`` acoustic weights are a later slice and raise
    ``NotImplementedError``.

    Vocoder (resolution rules 1-3 of the JAX ``load_synthesizer``), for
    ``vocoder_arch`` if given, else ``config.vocoder``:

    1. an explicit ``vocoder_path``: a ``.npz`` asset loads for either
       arch; a reference ``.pth.tar`` loads for HiFi-GAN
       (``core/import_torch.py``, weight norm folded); an orbax directory
       is a later slice;
    2. no path: the committed trained asset of the arch; with neither a
       path nor an arch given, the arch is promoted to the trained
       iSTFTNet, as the JAX package does when it serves its own weights;
    3. ``vocoder_path="random"``: a generator drawn from a seeded
       ``torch.Generator`` (``config.seed``). It cannot equal flax's
       random init, which draws from a ``jax.random`` key.
    """
    device = resolve_device(device)
    later = "is a later slice of the port (ROADMAP.md, Queue 1)"
    if ckpt_path is None:
        ckpt_path = default_acoustic_asset()
        if ckpt_path is None:
            raise FileNotFoundError("assets/acoustic/styler_gen.npz is missing")
    elif not ckpt_path.endswith(".npz"):
        raise NotImplementedError(f"acoustic checkpoint {ckpt_path!r}: only .npz assets load; "
                                  f"reference/orbax/random weights {later}")
    params, batch_stats = load_acoustic_npz(ckpt_path)

    if vocoder_arch:
        config = config.replace(vocoder=vocoder_arch)
    elif vocoder_path is None:
        config = config.replace(vocoder="iSTFTNet")
    if vocoder_path == "random":
        vocoder_params = _random_vocoder(config)
    elif vocoder_path is None:
        asset = default_vocoder_asset(config.vocoder)
        if asset is None:
            raise FileNotFoundError(f"no committed trained {config.vocoder} asset in assets/vocoder/")
        vocoder_params = load_vocoder_npz(asset)
    elif not os.path.exists(vocoder_path):
        raise FileNotFoundError(f"vocoder checkpoint: {vocoder_path}")
    elif os.path.isdir(vocoder_path):
        raise NotImplementedError(f"vocoder checkpoint {vocoder_path!r}: an orbax directory {later}")
    elif vocoder_path.endswith(".npz"):
        vocoder_params = load_vocoder_npz(vocoder_path)
    else:
        vocoder_params = load_reference_vocoder(vocoder_path, config.vocoder)
    return Synthesizer(config, params, batch_stats, vocoder_params, device)
