"""The port's STYLER eval forward against ``STYLER.apply`` on the
committed trained acoustic asset, at the small buckets of
tests/test_synthesis.py (src 32, mel 64), with seeded numpy inputs.

Both sides run exact f32 (the JAX tests at ``highest`` matmul precision);
sums differ in order, so every head is compared at a tolerance relative to
its own scale: 1e-4 of max |x| (measured worst: 1.7e-5 on p_prediction).
Integer heads (lengths, masks) must agree exactly.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from styler_tpu.core.checkpoint import load_acoustic_npz as j_load
from styler_tpu.core.config import default_config as j_config
from styler_tpu.models import STYLER as JSTYLER
from styler_tpu_torch.core.checkpoint import load_acoustic_npz
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.core.convert import load_flax_tree
from styler_tpu_torch.models import STYLER
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)

ASSET = "assets/acoustic/styler_gen.npz"
B, L, M = 2, 32, 64
REL = 1e-4


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1234)
    src_len = np.array([19, 32])
    mel_len = np.array([47, 64])
    src = rng.integers(1, 150, (B, L))
    mel = rng.normal(-5, 2, (B, M, 80)).astype(np.float32)
    p = rng.uniform(0, 1, (B, M)).astype(np.float32)
    p[p < 0.3] = 0  # unvoiced frames
    e = rng.uniform(0, 1, (B, M)).astype(np.float32)
    for b in range(B):
        src[b, src_len[b]:] = 0
        mel[b, mel_len[b]:] = 0
        p[b, mel_len[b]:] = 0
        e[b, mel_len[b]:] = 0
    spk = rng.standard_normal((B, 512)).astype(np.float32)
    spk /= np.linalg.norm(spk, axis=1, keepdims=True)
    return src, mel, p, e, src_len, mel_len, spk


@pytest.fixture(scope="module")
def jax_out(inputs, tmp_path_factory):
    def compute():
        out = _jax_forward(*inputs)
        return dict(out._asdict(), dat_posteriors=list(out.dat_posteriors))

    return SimpleNamespace(**golden(tmp_path_factory, "model_eval", compute))


def _jax_forward(src, mel, p, e, src_len, mel_len, spk):
    params, stats = j_load(ASSET)
    model = JSTYLER(j_config().replace(src_buckets=(L,), mel_buckets=(M,)))
    out = jax.jit(lambda v, *a: model.apply(
        v, src_seq=a[0], mel_target=a[1], mel_aug=a[1], p_norm=a[2], e_input=a[3],
        src_len=a[4], mel_len=a[5], max_src_len=L, max_mel_len=M, speaker_embed=a[6],
    ))(
        {"params": params, "batch_stats": stats},
        jnp.asarray(src, jnp.int32), jnp.asarray(mel), jnp.asarray(p), jnp.asarray(e),
        jnp.asarray(src_len, jnp.int32), jnp.asarray(mel_len, jnp.int32), jnp.asarray(spk),
    )
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def port_out(inputs):
    src, mel, p, e, src_len, mel_len, spk = inputs
    model = STYLER(default_config().replace(src_buckets=(L,), mel_buckets=(M,)))
    load_flax_tree(model, *load_acoustic_npz(ASSET))
    t = torch.from_numpy
    with torch.no_grad():
        out = model.eval()(t(src), t(mel), t(mel), t(p), t(e), t(src_len), t(mel_len), M, t(spk))
    return out


def _close(got, want):
    got = got.detach().numpy().astype(np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= REL * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("field", [
    "mel", "mel_noisy", "mel_postnet", "mel_postnet_noisy",
    "log_d_prediction", "p_prediction", "e_prediction",
])
def test_float_heads(jax_out, port_out, field):
    _close(getattr(port_out, field), getattr(jax_out, field))


@pytest.mark.parametrize("field", ["src_mask", "mel_mask", "mel_len"])
def test_integer_heads(jax_out, port_out, field):
    np.testing.assert_array_equal(getattr(port_out, field).numpy(), getattr(jax_out, field))


def test_dat_posteriors(jax_out, port_out):
    assert len(port_out.dat_posteriors) == 3
    for got, want in zip(port_out.dat_posteriors, jax_out.dat_posteriors):
        _close(got, want)


@pytest.mark.parametrize("key", ["t", "t_neck", "p_down", "s_down", "d", "s", "e", "n"])
def test_encodings(jax_out, port_out, key):
    assert set(port_out.encodings) == set(jax_out.encodings)
    _close(port_out.encodings[key], jax_out.encodings[key])
