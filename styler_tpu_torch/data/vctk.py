"""The speaker embedder of the VCTK front end (counterpart of
``default_speaker_asset`` and ``SpeakerEmbedder`` in
``styler_tpu/data/vctk.py:87-197``; the rest of that module, offline
preprocessing, is a later slice of the port).
"""

from __future__ import annotations

import os
import sys
from typing import Optional

import numpy as np
import torch

from styler_tpu_torch.core.config import Config
from styler_tpu_torch.core.device import resolve_device

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def default_speaker_asset() -> Optional[str]:
    """Path to the committed trained speaker encoder, or None."""
    path = os.path.join(_REPO, "assets", "speaker", "encoder_gen.npz")
    return path if os.path.exists(path) else None


class SpeakerEmbedder:
    """Speaker embedder with the JAX package's three-tier resolution:

    1. the reference's pretrained DeepSpeaker ``.h5``
       (``config.speaker_embedder_dir``) when present, as ``ResCNN``;
    2. the committed trained :class:`SpeakerEncoder` asset
       (``assets/speaker/encoder_gen.npz``);
    3. the deterministic spectral-envelope fallback (float64 numpy, the
       same numbers on every device).

    ``backend`` pins a tier: "auto" (default), "h5", "native" (trained
    asset) or "fallback". The encoder runs on ``device`` (CUDA unless
    ``device="cpu"``; with no CUDA device and no device given this raises).
    """

    def __init__(self, config: Config, backend: str = "auto", device=None):
        self.config = config
        self.device = resolve_device(device)
        self.model = None
        h5 = config.speaker_embedder_dir
        native = default_speaker_asset()
        if backend not in ("auto", "h5", "native", "fallback"):
            raise ValueError(f"unknown speaker backend: {backend}")
        if backend in ("auto", "h5") and os.path.exists(h5):
            from styler_tpu_torch.speaker import ResCNN, import_deepspeaker_h5

            self.model = ResCNN()
            variables = import_deepspeaker_h5(h5)
            params, batch_stats = variables["params"], variables["batch_stats"]
        elif backend == "h5":
            raise FileNotFoundError(h5)
        elif backend in ("auto", "native") and native:
            from styler_tpu_torch.core.checkpoint import load_acoustic_npz
            from styler_tpu_torch.speaker import SpeakerEncoder

            params, batch_stats = load_acoustic_npz(native)
            self.model = SpeakerEncoder()
            print(f"[vctk] speaker embedder: trained native asset {native}", file=sys.stderr)
        elif backend == "native":
            raise FileNotFoundError("assets/speaker/encoder_gen.npz")
        elif backend == "auto":
            print(
                f"[vctk] speaker embedder checkpoint not found at {h5}; "
                "writing deterministic fallback embeddings",
                file=sys.stderr,
            )
        if self.model is not None:
            from styler_tpu_torch.core.convert import load_flax_tree

            load_flax_tree(self.model, params, batch_stats)
            self.model.to(self.device).eval()

    def embed_wav(self, audio: np.ndarray, rng=None) -> np.ndarray:
        """Audio in [-1, 1] -> [1, speaker_embed_dim] float32."""
        if self.model is None:
            return self._fallback(audio)
        from styler_tpu_torch.speaker import speaker_features_from_audio

        feats = speaker_features_from_audio(
            audio, self.config.sampling_rate, self.config.win_length, rng=rng,
        )  # [T, 64, 1]
        x = torch.from_numpy(feats).permute(2, 0, 1)[None].to(self.device)
        with torch.no_grad():
            return self.model(x).cpu().numpy()

    def _fallback(self, audio: np.ndarray) -> np.ndarray:
        """Deterministic pseudo-embedding: the long-term average log power
        spectrum of the energetic frames, integrated into 512 log-spaced
        bands (50 Hz..Nyquist), a crude spectral-envelope signature
        (``styler_tpu/data/vctk.py:149-182``)."""
        sr = self.config.sampling_rate
        frame, hop = 1024, 512
        dim = self.config.speaker_embed_dim
        x = audio.astype(np.float64)
        if len(x) < frame:
            x = np.pad(x, (0, frame - len(x)))
        nfr = 1 + (len(x) - frame) // hop
        idx = np.arange(frame)[None] + hop * np.arange(nfr)[:, None]
        frames = x[idx] * np.hanning(frame)
        P = np.abs(np.fft.rfft(frames, axis=1)) ** 2
        en = P.sum(axis=1)
        P = P[en >= np.quantile(en, 0.4)].mean(axis=0)
        freqs = np.fft.rfftfreq(frame, 1.0 / sr)
        edges = np.geomspace(50.0, sr / 2, dim + 1)
        band = np.searchsorted(edges, freqs) - 1
        valid = (band >= 0) & (band < dim)
        v = np.zeros(dim)
        cnt = np.zeros(dim)
        np.add.at(v, band[valid], P[valid])
        np.add.at(cnt, band[valid], 1)
        v = np.log(v / np.maximum(cnt, 1) + 1e-10)
        v -= v.mean()
        v /= np.linalg.norm(v) + 1e-9
        return v.astype(np.float32)[None, :]
