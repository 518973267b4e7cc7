"""Weight conversion from the committed flax-style assets into the port's
modules: every leaf used exactly once, and the layout maps right."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from styler_tpu.vocoder.hifigan import ConvTranspose1dTorch as JConvT
from styler_tpu_torch.core.checkpoint import flatten_tree, load_acoustic_npz, load_vocoder_npz
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.core.convert import load_flax_tree
from styler_tpu_torch.models import STYLER
from styler_tpu_torch.vocoder.hifigan import ConvTranspose1dTorch
from styler_tpu_torch.vocoder.istft_net import ISTFTNetGenerator
from tests.test_torch_golden_cache import torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def acoustic():
    return load_acoustic_npz("assets/acoustic/styler_gen.npz")


@pytest.fixture(scope="module")
def vocoder():
    return load_vocoder_npz("assets/vocoder/istft_gen.npz")


def test_acoustic_asset_every_leaf_once(acoustic):
    params, stats = acoustic
    model = STYLER(default_config())
    used_p, used_s = load_flax_tree(model, params, stats)
    assert used_p == set(flatten_tree(params)) and len(used_p) == 305
    assert used_s == set(flatten_tree(stats)) and len(used_s) == 10
    n_numel = sum(v.size for v in flatten_tree(params).values())
    assert n_numel == sum(p.numel() for p in model.parameters())


def test_vocoder_asset_every_leaf_once(vocoder):
    gen = ISTFTNetGenerator()
    used, _ = load_flax_tree(gen, vocoder)
    assert used == set(flatten_tree(vocoder)) and len(used) == 80
    assert sum(v.size for v in flatten_tree(vocoder).values()) == sum(
        p.numel() for p in gen.parameters()
    )


def test_layouts(acoustic, vocoder):
    params, stats = acoustic
    model = STYLER(default_config())
    load_flax_tree(model, params, stats)
    sm = params["style_modeling"]
    np.testing.assert_array_equal(
        model.style_modeling.speaker_linear.weight.detach().numpy(), sm["speaker_linear"]["kernel"].T
    )
    conv = sm["duration_predictor"]["conv1d_1"]["kernel"]  # [k, in, out]
    np.testing.assert_array_equal(
        model.style_modeling.duration_predictor.conv1d_1.weight.detach().numpy(),
        conv.transpose(2, 1, 0),
    )
    np.testing.assert_array_equal(
        model.postnet.bn_0.running_var.numpy(), stats["postnet"]["bn_0"]["var"]
    )
    lstm = sm["audio_encoder"]["lstm_r"]
    assert model.style_modeling.audio_encoder.lstm_r.l0_fwd_w_hh.shape == (256, 64)
    np.testing.assert_array_equal(
        model.style_modeling.audio_encoder.lstm_r.l0_fwd_w_hh.detach().numpy(), lstm["l0_fwd_w_hh"]
    )
    gen = ISTFTNetGenerator()
    load_flax_tree(gen, vocoder)
    np.testing.assert_array_equal(
        gen.resblocks_1_2.w2[1].detach().numpy(), vocoder["resblocks_1_2"]["convs2_1"]["kernel"]
    )


def test_missing_and_extra_leaves_raise(vocoder):
    tree = {k: dict(v) for k, v in vocoder.items()}
    del tree["conv_post"]["bias"]
    with pytest.raises(KeyError):
        load_flax_tree(ISTFTNetGenerator(), tree)
    tree = {k: dict(v) for k, v in vocoder.items()}
    tree["extra"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="not loaded"):
        load_flax_tree(ISTFTNetGenerator(), tree)


@pytest.mark.parametrize("k,u,T_", [(16, 8, 5), (16, 8, 32), (4, 2, 9)])
def test_conv_transpose_mapping(k, u, T_):
    """flax flipped [k, in, out] kernel run as a dilated conv == torch
    conv_transpose1d with weight flip(kernel, 0).permute(1, 2, 0); output
    length u*T (8T for k=16, u=8)."""
    rng = np.random.default_rng(k * T_)
    x = rng.standard_normal((2, T_, 6)).astype(np.float32)
    jm = JConvT(4, k, u)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)), v
    )
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    tm = ConvTranspose1dTorch(6, 4, k, u)
    load_flax_tree(tm, jax.tree_util.tree_map(np.asarray, v["params"]))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, u * T_, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
