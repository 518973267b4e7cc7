"""Host wav reading (soundfile-free; a copy of ``read_wav`` /
``read_wav_int`` from ``styler_tpu/data/audio_io.py``)."""

from __future__ import annotations

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
