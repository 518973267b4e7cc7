"""Fundamental-frequency (f0) estimation on the host (a copy of the
native/numpy tiers of ``styler_tpu/dsp/pitch.py``; the on-device tracker
is a later slice).

The reference delegates to two native libraries (SURVEY §2.3):
- clean speech: pyworld DIO at frame_period = hop/sr*1000 ms
  (reference dataset.py:32-37),
- noisy speech: pysptk RAPT, log-f0 then exp (dataset.py:40-45; DIO
  fails on noisy audio, reference README.md:157).

This module provides the same contract (hop-aligned frames, f0 in Hz,
0.0 at unvoiced frames, clean/noisy variants) with two backends:

1. ``native``: the C++ host library in native/ (ctypes), a from-scratch
   NCCF pitch tracker with DIO-style band candidates — the production
   path for preprocessing throughput.
2. ``numpy``: a pure-numpy normalized-autocorrelation tracker — always
   available, used as fallback and as the golden model for the native
   implementation's tests.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_native_lib = None

# Octave-guard tolerance: a candidate local maximum at a shorter lag
# within this absolute NCCF distance of the global best wins (defeats
# the systematic subharmonic preference at non-integer periods and
# under additive noise; see tools/f0_benchmark.py).
_OCTAVE_DELTA = 0.045


def _load_native() -> Optional[ctypes.CDLL]:
    global _native_lib
    if _native_lib is not None:
        return _native_lib
    path = os.path.join(os.path.dirname(__file__), "..", "..", "native", "build", "libstyler_dsp.so")
    path = os.path.abspath(path)
    if os.path.exists(path):
        lib = ctypes.CDLL(path)
        lib.styler_track_f0.restype = ctypes.c_int
        lib.styler_track_f0.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # signal
            ctypes.c_int,  # n samples
            ctypes.c_int,  # sample rate
            ctypes.c_int,  # hop
            ctypes.c_float,  # f0 min
            ctypes.c_float,  # f0 max
            ctypes.c_int,  # robust (noisy) mode
            ctypes.POINTER(ctypes.c_float),  # out f0 [n//hop + 1]
        ]
        _native_lib = lib
    return _native_lib


def _frame_f0_numpy(
    x: np.ndarray,
    sr: int,
    hop: int,
    f0_min: float,
    f0_max: float,
    robust: bool,
) -> np.ndarray:
    """Normalized-autocorrelation (NCCF-style) pitch tracking.

    Per hop-aligned frame: window of ~2.5 longest periods, NCCF over the
    lag range [sr/f0_max, sr/f0_min], peak pick with parabolic refinement,
    voicing by NCCF threshold; 3-point median smoothing over the track.
    """
    x = np.asarray(x, dtype=np.float64)
    x = x - x.mean()
    n_frames = len(x) // hop + 1
    lag_min = max(2, int(sr / f0_max))
    lag_max = min(int(sr / f0_min) + 1, len(x) - 1)
    win = int(min(2.5 * lag_max, 4 * hop))
    thresh = 0.50 if robust else 0.45
    global_peak = np.abs(x).max() + 1e-12

    f0 = np.zeros(n_frames)
    nccf_best = np.zeros(n_frames)
    for i in range(n_frames):
        center = i * hop
        start = max(0, center - win // 2)
        seg = x[start: start + win + lag_max]
        if len(seg) < lag_min + 8:
            continue
        frame = seg[:win]
        e0 = np.dot(frame, frame)
        if e0 < 1e-10 or np.abs(frame).max() < 0.02 * global_peak:
            continue
        max_lag = min(lag_max, len(seg) - win)
        if max_lag <= lag_min:
            continue
        # NCCF(k) = sum x[t] x[t+k] / sqrt(e0 * e_k), vectorized by FFT
        nfft = 1
        while nfft < win + max_lag:
            nfft *= 2
        spec = np.fft.rfft(seg, nfft)
        ac_full = np.fft.irfft(np.conj(np.fft.rfft(frame, nfft)) * spec, nfft)
        cross = ac_full[: max_lag + 1]
        csum = np.cumsum(seg * seg)
        e_k = csum[win - 1 + np.arange(max_lag + 1)] - np.concatenate(
            [[0.0], csum[: max_lag]]
        )
        nccf = cross / np.sqrt(e0 * np.maximum(e_k, 1e-10))
        band = nccf[lag_min: max_lag + 1]
        if band.size == 0:
            continue
        best = float(band.max())
        if best < thresh:
            continue
        # Octave guard: subharmonic lags (2T, 3T...) of a periodic frame
        # tie with the true period — and at NON-integer true periods the
        # subharmonic can land nearer an integer lag and score strictly
        # higher (0.2% at SNR inf, a few % under noise). Pick the
        # smallest-lag LOCAL MAXIMUM within an absolute tolerance of the
        # best score (RAPT's octave cost collapsed to a hard window).
        pad = np.concatenate([[-2.0], band, [-2.0]])
        local_max = (band >= pad[:-2]) & (band >= pad[2:])
        cand = local_max & (band >= max(best - _OCTAVE_DELTA, thresh))
        k = int(np.argmax(cand)) + lag_min
        score = nccf[k]
        # parabolic interpolation around the peak
        if 0 < k < max_lag:
            y0, y1, y2 = nccf[k - 1], nccf[k], nccf[k + 1]
            denom = y0 - 2 * y1 + y2
            delta = 0.5 * (y0 - y2) / denom if abs(denom) > 1e-12 else 0.0
            delta = float(np.clip(delta, -0.5, 0.5))
        else:
            delta = 0.0
        f0[i] = sr / (k + delta)
        nccf_best[i] = score

    # median-3 smoothing on voiced runs; kill isolated voiced frames
    sm = f0.copy()
    for i in range(1, n_frames - 1):
        window3 = f0[i - 1: i + 2]
        voiced = window3 > 0
        if f0[i] > 0 and voiced.sum() >= 2:
            sm[i] = np.median(window3[voiced])
        elif f0[i] > 0 and voiced.sum() == 1:
            sm[i] = 0.0
    out = np.where((sm >= f0_min) & (sm <= f0_max), sm, 0.0)
    return out


def track_f0(
    wav: np.ndarray,
    sampling_rate: int = 22050,
    hop_length: int = 256,
    f0_min: float = 71.0,
    f0_max: float = 797.9,
    robust: bool = False,
    backend: Optional[str] = None,
) -> np.ndarray:
    """f0 per hop frame [len(wav)//hop + 1]; 0.0 where unvoiced.

    backend: None/"native" (the repository's C++ library when it is
    built and loads, else numpy) or "numpy"."""
    wav = np.asarray(wav, dtype=np.float32)
    lib = None if backend == "numpy" else _load_native()
    if lib is not None:
        n_frames = len(wav) // hop_length + 1
        out = np.zeros(n_frames, dtype=np.float32)
        rc = lib.styler_track_f0(
            wav.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            len(wav),
            sampling_rate,
            hop_length,
            f0_min,
            f0_max,
            1 if robust else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc == 0:
            return out.astype(np.float64)
    return _frame_f0_numpy(wav, sampling_rate, hop_length, f0_min, f0_max, robust)


def get_f0(wav: np.ndarray, config, duration=None) -> np.ndarray:
    """Clean-speech f0 (reference dataset.py:32-37 contract)."""
    f0 = track_f0(
        wav, config.sampling_rate, config.hop_length, config.f0_min, config.f0_max
    )
    if duration is not None:
        f0 = f0[: sum(duration)]
    return f0


def get_f0_noisy(wav: np.ndarray, config, duration=None) -> np.ndarray:
    """Noise-robust f0 (reference dataset.py:40-45 contract)."""
    f0 = track_f0(
        wav,
        config.sampling_rate,
        config.hop_length,
        config.f0_min,
        config.f0_max,
        robust=True,
    )
    if duration is not None:
        f0 = f0[: sum(duration)]
    return f0
