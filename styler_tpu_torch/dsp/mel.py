"""STFT / mel-spectrogram / frame-energy front end (counterpart of
``styler_tpu/dsp/mel.py:MelFrontend``).

Reference semantics: reflect-pad ``filter_length//2`` on both sides
(done on the host), frames of ``filter_length`` at ``hop_length`` stride
(``n_frames = len(x)//hop + 1``), a periodic Hann window centered in
``filter_length``, the magnitude spectrum (``torch.fft.rfft``), a
slaney-normalized mel filterbank, ``log(clamp(x, 1e-5))``, and energy as
the L2 norm of the linear magnitudes per frame. Frame counts are padded
to power-of-two buckets from 32, as the reference pads them.
"""

from __future__ import annotations

import numpy as np
import torch


def hann_periodic(win_length: int) -> np.ndarray:
    """Periodic Hann window == scipy.signal.get_window('hann', N, fftbins=True)."""
    n = np.arange(win_length)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


def pad_center(window: np.ndarray, size: int) -> np.ndarray:
    """Zero-pad a window symmetrically to ``size`` (librosa.util.pad_center)."""
    lpad = (size - len(window)) // 2
    out = np.zeros(size, dtype=window.dtype)
    out[lpad:lpad + len(window)] = window
    return out


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    mel = f / f_sp
    log_region = f >= min_log_hz
    return np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mel)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    f = m * f_sp
    log_region = m >= min_log_mel
    return np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), f)


def mel_filterbank(sampling_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular mel filterbank
    (librosa.filters.mel defaults). Returns [n_mels, n_fft//2 + 1]."""
    fftfreqs = np.linspace(0.0, sampling_rate / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    mel_f = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


class MelFrontend:
    """Mel front end on ``device``: ``(audio [T] in [-1, 1]) -> (mel
    [n_mels, F], energy [F])`` as numpy arrays, F = T // hop + 1."""

    _FRAME_BUCKET_BASE = 32

    def __init__(self, config, device="cpu"):
        self.config = config
        self.device = torch.device(device)
        self.n_fft = config.filter_length
        self.hop_length = config.hop_length
        window = pad_center(hann_periodic(config.win_length), config.filter_length)
        self.window = torch.from_numpy(window.astype(np.float32)).to(self.device)
        self.mel_basis = torch.from_numpy(
            mel_filterbank(config.sampling_rate, config.filter_length,
                           config.n_mel_channels, config.mel_fmin, config.mel_fmax)
        ).to(self.device)

    def _mel_energy_prepadded(self, xp: torch.Tensor):
        """xp: already reflect + bucket padded; valid framing only."""
        frames = xp.unfold(0, self.n_fft, self.hop_length) * self.window[None, :]
        mag = torch.abs(torch.fft.rfft(frames, n=self.n_fft, dim=-1)).T
        mel = torch.log(torch.clamp(self.mel_basis @ mag, min=1e-5))
        energy = torch.linalg.vector_norm(mag, dim=0)
        return mel, energy

    def __call__(self, audio) -> tuple:
        audio = np.asarray(audio, dtype=np.float32)
        pad = self.n_fft // 2
        xp = np.pad(audio, (pad, pad), mode="reflect")
        F = len(audio) // self.hop_length + 1
        Fb = self._FRAME_BUCKET_BASE
        while Fb < F:
            Fb *= 2
        total = (Fb - 1) * self.hop_length + self.n_fft
        # pad OR truncate to the bucket length: samples past `total` are
        # beyond the last frame's reach
        xp = np.pad(xp, (0, max(0, total - len(xp))))[:total]
        mel, energy = self._mel_energy_prepadded(torch.from_numpy(xp).to(self.device))
        return mel[:, :F].cpu().numpy(), energy[:F].cpu().numpy()
