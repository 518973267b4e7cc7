"""The port's teacher-forced train-mode forward against the JAX package:
``STYLER.apply(..., deterministic=True, train=True, mutable=["batch_stats"])``
on the same randomly initialised weights and the same ragged batch, at a
reduced depth (1 + 1 FFT layers, FFN 256), B = 2, L = 12, M = 48.

Batch statistics without dropout, since the two packages' random streams
cannot be made equal; dropout is checked alone, by its distribution. Exact
f32 on both sides with sums in another order: 1e-4 of each head's scale.
"""

from types import SimpleNamespace

import flax
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from styler_tpu.core.config import default_config as j_config
from styler_tpu.models import STYLER as JSTYLER
from styler_tpu.train.step import FORWARD_KEYS as J_FORWARD_KEYS
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.core.convert import to_flax_tree
from styler_tpu_torch.core.checkpoint import flatten_tree
from styler_tpu_torch.models.transformer import PostNet
from styler_tpu_torch.ops.dropout import dropout
from styler_tpu_torch.train import FORWARD_KEYS, train_state_from_flax
from styler_tpu_torch.train.example import example_batch
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)

REDUCED = dict(encoder_layer=1, decoder_layer=1, fft_conv1d_filter_size=256)
B, L, M = 2, 12, 48
REL = 1e-4
T = torch.from_numpy


def _as_torch(batch):
    return {k: T(v).to(torch.int64) if v.dtype.kind == "i" else T(v) for k, v in batch.items()}


def _forward(model, tb, gen=None):
    return model(
        tb["src_seq"], tb["mel_target"], tb["mel_aug"], tb["p_norm"], tb["e_input"],
        tb["src_len"], tb["mel_len"], M, tb["speaker_embed"], d_target=tb["d_target"],
        p_target=tb["p_target"], e_target=tb["e_target"], dropout=gen,
    )


def _jax_golden():
    """flax init and the train-mode forward + DAT pass, as numpy."""
    batch = example_batch(default_config(), B=B, L=L, M=M, seed=11)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fwd = {k: jb[k] for k in J_FORWARD_KEYS}
    model = JSTYLER(j_config().replace(**REDUCED))
    variables = flax.core.unfreeze(jax.jit(model.init)(jax.random.PRNGKey(0), **fwd))

    @jax.jit
    def run(variables):
        out, mutated = model.apply(
            variables, **fwd, deterministic=True, train=True, mutable=["batch_stats"]
        )
        dat = model.apply(
            variables, jb["mel_aug"], jb["f0_norm_aug"], jb["e_input_aug"], jb["mel_len"],
            jb["src_len"], out.src_mask, method="forward_dat",
        )
        return out, mutated["batch_stats"], dat

    j_out, j_stats, j_dat = jax.tree_util.tree_map(np.asarray, run(variables))
    params, stats = jax.tree_util.tree_map(np.asarray, (variables["params"], variables["batch_stats"]))
    return dict(j_out=dict(j_out._asdict(), dat_posteriors=list(j_out.dat_posteriors)),
                j_stats=flax.core.unfreeze(j_stats), j_dat=list(j_dat), params=params, stats=stats)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    assert FORWARD_KEYS == J_FORWARD_KEYS
    batch = example_batch(default_config(), B=B, L=L, M=M, seed=11)
    assert batch["mel_len"][1] < M and batch["src_len"][1] <= L  # ragged
    gold = golden(tmp_path_factory, "train_model", _jax_golden)
    stats = gold["stats"]
    state = train_state_from_flax(default_config().replace(**REDUCED), gold["params"], stats,
                                  device="cpu")
    assert state.model.training
    tb = _as_torch(batch)
    with torch.no_grad():
        t_out = _forward(state.model, tb)
        t_dat = state.model.forward_dat(
            tb["mel_aug"], tb["f0_norm_aug"], tb["e_input_aug"], tb["mel_len"], tb["src_len"],
            t_out.src_mask,
        )
    return dict(j_out=SimpleNamespace(**gold["j_out"]), j_stats=gold["j_stats"],
                j_dat=gold["j_dat"], t_out=t_out, t_dat=t_dat, model=state.model, tb=tb,
                old_stats=stats)


def _close(got, want):
    got = got.detach().numpy().astype(np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= REL * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("field", [
    "mel", "mel_noisy", "mel_postnet", "mel_postnet_noisy",
    "log_d_prediction", "p_prediction", "e_prediction",
])
def test_float_heads(both, field):
    _close(getattr(both["t_out"], field), getattr(both["j_out"], field))


@pytest.mark.parametrize("field", ["src_mask", "mel_mask", "mel_len"])
def test_teacher_forced_masks_and_lengths_are_the_callers(both, field):
    got = getattr(both["t_out"], field).numpy()
    np.testing.assert_array_equal(got, getattr(both["j_out"], field))
    if field == "mel_len":
        np.testing.assert_array_equal(got, both["tb"]["mel_len"].numpy())


def test_dat_posteriors_of_both_passes(both):
    for got, want in zip(both["t_out"].dat_posteriors, both["j_out"].dat_posteriors):
        _close(got, want)
    assert len(both["t_dat"]) == 3
    for got, want in zip(both["t_dat"], both["j_dat"]):
        _close(got, want)


@pytest.mark.parametrize("key", ["t", "t_neck", "p_down", "s_down", "d", "s", "e", "n"])
def test_encodings(both, key):
    _close(both["t_out"].encodings[key], both["j_out"].encodings[key])


def test_batch_stats_after_the_two_decodes_match_flax(both):
    """Two momentum updates (clean decode, then noisy decode) towards the
    BIASED batch variance over all B*M positions, as flax."""
    _, got = to_flax_tree(both["model"])
    got, want, old = (flatten_tree(t) for t in (got, both["j_stats"], both["old_stats"]))
    assert set(got) == set(want) and len(want) == 10
    told_apart = False
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=REL, atol=REL)
        assert np.abs(w - old[k]).max() > 1e-3  # the statistics moved
        if k.endswith("var"):
            # what torch's own BatchNorm1d (unbiased variance) would have
            # stored differs by more than the tolerance somewhere
            n = B * M
            unbiased = 0.81 * old[k] + (w - 0.81 * old[k]) * n / (n - 1)
            told_apart |= bool(np.abs(unbiased - w).max() > 10 * REL * max(np.abs(w).max(), 1.0))
    assert told_apart


def test_eval_mode_keeps_the_statistics_and_one_2b_pass(both):
    model, tb = both["model"], both["tb"]
    before = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
    model.eval()
    try:
        with torch.no_grad():
            out = _forward(model, tb)
    finally:
        model.train()
    for k, v in before.items():
        assert torch.equal(model.state_dict()[k], v)
    assert out.mel.shape == (B, M, 80) and torch.isfinite(out.mel_postnet_noisy).all()


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    g = torch.Generator().manual_seed(0)
    x = torch.ones(200, 500)
    y = dropout(x, rate, g)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.01
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / (1 - rate), rtol=1e-6)
    assert dropout(x, rate, None) is x and dropout(x, 0.0, g) is x


def test_same_generator_seed_gives_the_same_forward(both):
    model, tb = both["model"], both["tb"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    outs = []
    for seed in (5, 5, 6):
        model.load_state_dict(before)
        with torch.no_grad():
            outs.append(_forward(model, tb, torch.Generator().manual_seed(seed)))
    model.load_state_dict(before)
    for f in ("mel", "mel_postnet_noisy", "log_d_prediction", "p_prediction"):
        assert torch.equal(getattr(outs[0], f), getattr(outs[1], f))
        assert not torch.equal(getattr(outs[0], f), getattr(outs[2], f))
    # dropout reaches the decode but not the DAT heads (audio encoder has none)
    assert torch.equal(outs[0].dat_posteriors[0], outs[2].dat_posteriors[0])
    assert not torch.equal(outs[0].mel, both["t_out"].mel)


def test_postnet_drops_after_every_conv_including_the_last():
    """Rate 0.5 after all five convs: about half of the output is exactly 0."""
    net = PostNet().train()
    y = net(torch.randn(2, 40, 80), torch.Generator().manual_seed(0))
    assert 0.4 < (y == 0).float().mean().item() < 0.6
    assert not (net(torch.randn(2, 40, 80), None) == 0).any()
