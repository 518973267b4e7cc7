"""The port's tensor ops against the JAX package's, on the same numpy inputs.

Integer maps (masks, regulation indices, one-hot bins, bucket indices,
flips) must agree exactly; float results to f32 rounding (1e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from styler_tpu.dsp import features as jfeat
from styler_tpu.ops import masking as jmask
from styler_tpu.ops import position as jpos
from styler_tpu.ops import recurrent as jrec
from styler_tpu.ops import regulate as jreg
from styler_tpu_torch.dsp import features as tfeat
from styler_tpu_torch.ops import masking as tmask
from styler_tpu_torch.ops import position as tpos
from styler_tpu_torch.ops import recurrent as trec
from styler_tpu_torch.ops import regulate as treg
from tests.test_torch_golden_cache import torch_threads  # noqa: F401 (autouse)

T = torch.from_numpy


@pytest.mark.parametrize("lengths,max_len", [([3, 7, 0], 7), ([1], 5), ([4, 9], 12)])
def test_mask_from_lengths(lengths, max_len):
    lengths = np.asarray(lengths, np.int64)
    want = np.asarray(jmask.mask_from_lengths(jnp.asarray(lengths), max_len))
    got = tmask.mask_from_lengths(T(lengths), max_len).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,d,pad", [(1001, 256, None), (1024, 256, None), (40, 6, 0)])
def test_sinusoid_table(n, d, pad):
    np.testing.assert_array_equal(tpos.sinusoid_table(n, d, pad), jpos.sinusoid_table(n, d, pad))


@pytest.mark.parametrize("max_mel_len", [16, 40])
def test_length_regulate(max_mel_len):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 6, 4)).astype(np.float32)
    d = rng.integers(0, 5, (3, 6)).astype(np.int32)
    d[1, 3:] = 0
    want_x, want_len = jreg.length_regulate(jnp.asarray(x), jnp.asarray(d), max_mel_len)
    got_x, got_len = treg.length_regulate(T(x), T(d), max_mel_len)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))


# (mel_len, seq_len) pairs: compression (more frames than phonemes),
# expansion (fewer), equality, and the degenerate zero lengths
CALIB_CASES = [(57, 13), (64, 32), (9, 20), (3, 31), (17, 17), (0, 5), (7, 0)]


@pytest.mark.parametrize("mel_len,seq_len", CALIB_CASES)
def test_calibration_matrix(mel_len, seq_len):
    want = np.asarray(jreg.calibration_matrix(jnp.int32(mel_len), jnp.int32(seq_len), 64, 32))
    got = treg.calibration_matrix(T(np.array([mel_len])), T(np.array([seq_len])), 64, 32)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-7)


def test_mel_calibrate_batch():
    rng = np.random.default_rng(2)
    mel = rng.standard_normal((len(CALIB_CASES), 64, 5)).astype(np.float32)
    ml = np.array([c[0] for c in CALIB_CASES])
    sl = np.array([c[1] for c in CALIB_CASES])
    want = np.asarray(jreg.mel_calibrate(jnp.asarray(mel), jnp.asarray(ml), jnp.asarray(sl), 32))
    got = treg.mel_calibrate(T(mel), T(ml), T(sl), 32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_quantize_one_hot():
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.2, 1.0, (2, 50)).astype(np.float32)
    x[0, :5] = [0.0, 1.0, 0.5 / 255, 1.5 / 255, 254.5 / 255]  # zero, top, half-way ties
    want = np.asarray(jfeat.quantize_one_hot(jnp.asarray(x)))
    got = tfeat.quantize_one_hot(T(x)).numpy()
    assert got.shape == (2, 50, 257)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["pitch", "energy"])
def test_bucketize(kind):
    rng = np.random.default_rng(4)
    if kind == "pitch":
        edges = jfeat.pitch_bin_edges(71.0, 797.9)
        x = rng.uniform(0, 900, (3, 40)).astype(np.float32)
    else:
        edges = jfeat.energy_bin_edges(0.1, 525.43)
        x = rng.uniform(-1, 600, (3, 40)).astype(np.float32)
    np.testing.assert_array_equal(
        edges, tfeat.pitch_bin_edges(71.0, 797.9) if kind == "pitch"
        else tfeat.energy_bin_edges(0.1, 525.43)
    )
    x[0, :4] = edges[:4]  # exactly on a boundary
    want = np.asarray(jfeat.bucketize(jnp.asarray(x), jnp.asarray(edges)))
    np.testing.assert_array_equal(tfeat.bucketize(T(x), T(edges)).numpy(), want)


def test_host_feature_normalizations():
    rng = np.random.default_rng(5)
    f0 = np.abs(rng.standard_normal(80)) * 200
    f0[::7] = 0
    np.testing.assert_array_equal(tfeat.f0_normalization_np(f0), jfeat.f0_normalization_np(f0))
    np.testing.assert_array_equal(
        tfeat.f0_normalization_np(np.zeros(9)), jfeat.f0_normalization_np(np.zeros(9))
    )
    en = rng.uniform(0, 600, 80)
    np.testing.assert_array_equal(
        tfeat.energy_rescaling_np(en, 0.1, 525.43), jfeat.energy_rescaling_np(en, 0.1, 525.43)
    )


@pytest.mark.parametrize("lengths", [[11, 4, 1], [11, 11, 11]])
def test_flip_padded(lengths):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 11, 4)).astype(np.float32)
    lengths = np.asarray(lengths)
    want = np.asarray(jrec.flip_padded(jnp.asarray(x), jnp.asarray(lengths)))
    np.testing.assert_array_equal(trec.flip_padded(T(x), T(lengths)).numpy(), want)
