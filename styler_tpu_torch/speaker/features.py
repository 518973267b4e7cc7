"""Speaker-embedder input features: HTK-style filterbank energies (a copy of
``styler_tpu/speaker/features.py``).

Numpy reimplementation of the ``python_speech_features.fbank`` call used
by the reference DeepSpeaker front end (reference deepspeaker/audio_ds.py:
126-139): preemphasis 0.97, rectangular window, frame length
``win_length`` samples, step 10 ms, power spectrum |rfft|^2/nfft, 64 HTK
mel filters over [0, sr/2], per-frame mean/std normalization, plus the
crude 95th-percentile silence trim (audio_ds.py:35-46) and the 160-frame
crop/pad (batcher.py:23-29).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

NUM_FBANKS = 64
NUM_FRAMES = 160


def _round_half_up(x: float) -> int:
    return int(math.floor(x + 0.5))


def hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


def htk_filterbank(nfilt: int, nfft: int, samplerate: int,
                   lowfreq: float = 0.0, highfreq: Optional[float] = None) -> np.ndarray:
    highfreq = highfreq or samplerate / 2
    mel_pts = np.linspace(hz_to_mel_htk(lowfreq), hz_to_mel_htk(highfreq), nfilt + 2)
    bins = np.floor((nfft + 1) * mel_to_hz_htk(mel_pts) / samplerate).astype(int)
    fb = np.zeros((nfilt, nfft // 2 + 1))
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            fb[j, i] = (i - bins[j]) / max(bins[j + 1] - bins[j], 1)
        for i in range(bins[j + 1], bins[j + 2]):
            fb[j, i] = (bins[j + 2] - i) / max(bins[j + 2] - bins[j + 1], 1)
    return fb


def calculate_nfft(samplerate: int, winlen: float) -> int:
    """Power of two >= window sample count (audio_ds.py:18-32)."""
    window_length_samples = winlen * samplerate
    nfft = 1
    while nfft < window_length_samples:
        nfft *= 2
    return nfft


def fbank_features(
    signal: np.ndarray,
    samplerate: int = 22050,
    winlen: float = 0.025,
    winstep: float = 0.01,
    nfilt: int = NUM_FBANKS,
    nfft: Optional[int] = None,
    preemph: float = 0.97,
) -> np.ndarray:
    """Filterbank energies [n_frames, nfilt] (psf.fbank equivalent)."""
    nfft = nfft or calculate_nfft(samplerate, winlen)
    signal = np.asarray(signal, dtype=np.float64)
    signal = np.append(signal[0], signal[1:] - preemph * signal[:-1])

    frame_len = _round_half_up(winlen * samplerate)
    frame_step = _round_half_up(winstep * samplerate)
    slen = len(signal)
    if slen <= frame_len:
        numframes = 1
    else:
        numframes = 1 + int(math.ceil((slen - frame_len) / frame_step))
    padded = np.concatenate(
        [signal, np.zeros(max(0, (numframes - 1) * frame_step + frame_len - slen))]
    )
    idx = (
        np.tile(np.arange(frame_len), (numframes, 1))
        + np.tile(np.arange(numframes) * frame_step, (frame_len, 1)).T
    )
    frames = padded[idx]

    pspec = (np.abs(np.fft.rfft(frames, nfft, axis=-1)) ** 2) / nfft
    fb = htk_filterbank(nfilt, nfft, samplerate)
    feat = pspec @ fb.T
    feat = np.where(feat == 0, np.finfo(np.float64).eps, feat)
    return feat


def normalize_frames(m: np.ndarray, epsilon: float = 1e-12) -> np.ndarray:
    """Per-frame mean/std normalization (audio_ds.py:138-139)."""
    mean = m.mean(axis=1, keepdims=True)
    std = np.maximum(m.std(axis=1, keepdims=True), epsilon)
    return ((m - mean) / std).astype(np.float32)


def trim_silence(audio: np.ndarray) -> np.ndarray:
    """95th-percentile energy gate (audio_ds.py:35-46)."""
    energy = np.abs(audio)
    threshold = np.percentile(energy, 95)
    offsets = np.where(energy > threshold)[0]
    if len(offsets) < 2:
        return audio
    return audio[offsets[0]: offsets[-1]]


def speaker_features_from_audio(
    audio: np.ndarray,
    samplerate: int = 22050,
    win_length: int = 1024,
    max_frames: int = NUM_FRAMES,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Full reference pipeline: trim → fbank(winlen=win_length/sr) →
    per-frame normalize → crop/pad to 160 frames → [160, 64, 1]."""
    voiced = trim_silence(audio)
    feat = fbank_features(
        voiced, samplerate, winlen=win_length / samplerate, nfilt=NUM_FBANKS
    )
    feat = normalize_frames(feat)
    if feat.shape[0] >= max_frames:
        rng = rng or np.random.default_rng(0)
        start = int(rng.integers(0, feat.shape[0] - max_frames + 1))
        feat = feat[start: start + max_frames]
    else:
        feat = np.vstack(
            [feat, np.zeros((max_frames - feat.shape[0], feat.shape[1]), np.float32)]
        )
    return feat[..., None].astype(np.float32)
