"""The port's iSTFTNet generator on the committed trained asset
(``assets/vocoder/istft_gen.npz``) against the JAX package, on the first
32 frames of ``assets/vocoder/val_mel.npy``.

f32: against ``ISTFTNetGenerator(compute_dtype=float32).apply`` — exact
f32 on both sides, measured max error 1.6e-6 of a 0.45 peak -> atol 1e-5.
bf16: against ``istft_apply_fused(compute_dtype=bfloat16, interpret=True)``,
the Pallas path the reference serves with. Both carry the resblock residual
in f32, but the XLA and PyTorch bf16 convs (conv_pre, the upsamplers,
conv_post) round in other places. conv_post emits the iSTFT phase in bf16,
whose absolute error grows with the phase's magnitude, so sample-wise SNR
says little about bf16 audio (the port's own bf16 vs f32 output measures
5 to 17 dB). The waveforms are compared by the mean absolute difference of
their log-mels instead: measured 0.011 -> bound 0.05 (natural log units).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from styler_tpu.core.checkpoint import load_vocoder_npz as j_load
from styler_tpu.vocoder.istft_net import ISTFTNetGenerator as JGenerator
from styler_tpu.vocoder.istft_net import inverse_stft as j_istft
from styler_tpu.vocoder.istft_net import istft_apply_fused
from styler_tpu_torch.core.checkpoint import load_vocoder_npz
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.core.convert import load_flax_tree
from styler_tpu_torch.dsp.mel import MelFrontend
from styler_tpu_torch.vocoder.istft_net import ISTFTNetGenerator, inverse_stft
from tests.test_torch_golden_cache import torch_threads  # noqa: F401 (autouse)

ASSET = "assets/vocoder/istft_gen.npz"


@pytest.fixture(scope="module")
def mel():
    return np.load("assets/vocoder/val_mel.npy")[None, :32].astype(np.float32)


@pytest.fixture(scope="module")
def jparams():
    return j_load(ASSET)


def _port(dtype):
    g = ISTFTNetGenerator(compute_dtype=dtype)
    load_flax_tree(g, load_vocoder_npz(ASSET))
    return g.eval()


def _log_mel_mae(a, b):
    fe = MelFrontend(default_config())
    return float(np.abs(fe(a)[0] - fe(b)[0]).mean())


def test_istftnet_f32_matches_flax(mel, jparams):
    want = np.asarray(JGenerator(compute_dtype=jnp.float32).apply({"params": jparams}, jnp.asarray(mel)))
    with torch.no_grad():
        got = _port(torch.float32)(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (1, 32 * 256)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_istftnet_bf16_matches_fused_pallas(mel, jparams):
    want = np.asarray(istft_apply_fused(
        {"params": jparams}, jnp.asarray(mel), compute_dtype=jnp.bfloat16, interpret=True
    ))
    with torch.no_grad():
        got = _port(torch.bfloat16)(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _log_mel_mae(got[0], want[0]) < 0.05


@pytest.mark.parametrize("T_", [1, 7, 32])
def test_inverse_stft(T_):
    rng = np.random.default_rng(T_)
    mag = np.exp(rng.uniform(-3, 1, (2, T_, 9))).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, T_, 9)).astype(np.float32)
    want = np.asarray(j_istft(jnp.asarray(mag), jnp.asarray(phase), 16, 4))
    got = inverse_stft(torch.from_numpy(mag), torch.from_numpy(phase), 16, 4).numpy()
    assert got.shape == (2, T_ * 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
