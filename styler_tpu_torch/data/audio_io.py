"""Host wav IO + RMS normalization helpers (soundfile-free; a copy of
``styler_tpu/data/audio_io.py``).

Reproduces the reference noise mixer's audioread/audiowrite semantics
(reference data/noise_mixer.py:24-68): float32 in [-1, 1], optional
normalization to -25 dBFS RMS, multi-channel averaged to mono.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from scipy.io import wavfile


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (float32 samples scaled to [-1, 1], sample rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    return x, sr


def read_wav_int(path: str) -> Tuple[int, np.ndarray]:
    """Raw scipy read (int16 samples), like the reference's scipy usage."""
    sr, data = wavfile.read(path)
    return sr, data


def audioread(path: str, norm: bool = True) -> Tuple[np.ndarray, int, float]:
    """(mono float audio, sr, duration); norm -> -25 dBFS RMS."""
    x, sr = read_wav(path)
    if x.ndim > 1:
        x = x.T.sum(axis=0) / x.shape[1]
    duration = len(x) / sr
    if norm:
        rms = float((x**2).mean()) ** 0.5
        x = x * (10 ** (-25 / 20) / max(rms, 1e-12))
    return x, sr, duration


def audiowrite(data: np.ndarray, fs: int, destpath: str, norm: bool = False) -> None:
    if norm:
        eps = 1e-6
        rms = float((data**2).mean()) ** 0.5
        data = data * (10 ** (-25 / 10) / (rms + eps))
        peak = float(np.abs(data).max())
        if peak >= 1:
            data = data / max(peak, eps)
    os.makedirs(os.path.dirname(os.path.abspath(destpath)), exist_ok=True)
    wavfile.write(destpath, fs, (np.clip(data, -1, 1) * 32767).astype(np.int16))
