"""The training slice as a whole against the JAX package: the same weights
and ragged batch through the port's train step without dropout and through
a JAX loss built from ``model.apply`` + ``forward_dat`` + ``styler_loss`` +
``jax.value_and_grad`` (the reference's ``train_step`` with
``deterministic=True``; the two random streams cannot be made equal). Then
the optimizer update, the eval step, an overfit run, and save / restore.

Reduced depth (1 + 1 FFT layers, FFN 256), B = 2, L = 12, M = 48, CPU.
Exact f32 on both sides with sums in another order: components within 1e-5
relative, every gradient leaf within 1e-4 of max(1, max |jax grad|).
"""

import flax
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from styler_tpu.core.config import default_config as j_config
from styler_tpu.models import STYLER as JSTYLER
from styler_tpu.train.losses import styler_loss as j_styler_loss
from styler_tpu.train.state import TrainState as JTrainState
from styler_tpu.train.optimizer import make_optimizer
from styler_tpu.train.step import FORWARD_KEYS as J_FORWARD_KEYS, eval_step as j_eval_step
from styler_tpu_torch.core.checkpoint import flatten_tree
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.core.convert import to_flax_tree
from styler_tpu_torch.train import (
    compute_gradients,
    create_train_state,
    eval_step,
    train_state_from_flax,
    train_step,
)
from styler_tpu_torch.train.example import example_batch, write_example_dataset
from styler_tpu_torch.train.trainer import Trainer, dropout_generator

REDUCED = dict(encoder_layer=1, decoder_layer=1, fft_conv1d_filter_size=256)
B, L, M = 2, 12, 48
NAMES = ("total", "mel", "mel_postnet", "mel_noisy", "mel_postnet_noisy",
         "duration", "f0", "energy", "dat_clean", "dat_aug")
T = torch.from_numpy


def _as_torch(batch):
    return {k: T(v).to(torch.int64) if v.dtype.kind == "i" else T(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def both():
    jcfg = j_config().replace(**REDUCED)
    cfg = default_config().replace(**REDUCED)
    batch = example_batch(cfg, B=B, L=L, M=M, seed=21)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fwd = {k: jb[k] for k in J_FORWARD_KEYS}
    model = JSTYLER(jcfg)
    variables = flax.core.unfreeze(jax.jit(model.init)(jax.random.PRNGKey(3), **fwd))
    j_state = JTrainState.create(
        apply_fn=model.apply, params=variables["params"], tx=make_optimizer(jcfg),
        batch_stats=variables["batch_stats"],
    )

    def loss_fn(params, stats):
        v = {"params": params, "batch_stats": stats}
        out, mutated = model.apply(v, **fwd, deterministic=True, train=True,
                                   mutable=["batch_stats"])
        dat_aug = model.apply(v, jb["mel_aug"], jb["f0_norm_aug"], jb["e_input_aug"],
                              jb["mel_len"], jb["src_len"], out.src_mask, method="forward_dat")
        total, comps = j_styler_loss(out, jb["mel_target"], jb["mel_aug"], jb["log_d_target"],
                                     jb["p_target"], jb["e_target"], dat_aug, jcfg.dat_weight)
        return total, (comps, mutated["batch_stats"])

    @jax.jit
    def j_step(state):
        (_, (comps, new_stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params, state.batch_stats)
        return state.apply_gradients(grads=grads, batch_stats=new_stats), comps, grads

    j_new, j_comps, j_grads = j_step(j_state)
    j_eval = jax.jit(lambda s: j_eval_step(model, s, jb, jcfg.dat_weight))(j_state)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(t))  # noqa: E731
    params, stats = to_np(variables["params"]), to_np(variables["batch_stats"])

    state = train_state_from_flax(cfg, params, stats, device="cpu")
    tb = _as_torch(batch)
    t_eval = eval_step(state, tb, cfg.dat_weight)
    assert state.model.training  # eval_step leaves the model in train mode
    t_comps = compute_gradients(state, tb, None, cfg.dat_weight)
    t_grads, _ = to_flax_tree(state.model, grads=True)
    # the full step from the same start: same gradients, then the update
    state2 = train_state_from_flax(cfg, params, stats, device="cpu")
    _, t_comps2 = train_step(state2, tb, None, cfg.dat_weight)
    t_new, t_new_stats = to_flax_tree(state2.model)
    return dict(
        cfg=cfg, params=flatten_tree(params), j_comps=to_np(j_comps),
        j_grads=flatten_tree(to_np(j_grads)), j_new=flatten_tree(to_np(j_new.params)),
        j_new_stats=flatten_tree(to_np(j_new.batch_stats)), j_eval=to_np(j_eval),
        t_comps=t_comps, t_comps2=t_comps2, t_grads=flatten_tree(t_grads),
        t_new=flatten_tree(t_new), t_new_stats=flatten_tree(t_new_stats), t_eval=t_eval,
        state2=state2, tb=tb,
    )


@pytest.mark.parametrize("name", NAMES)
def test_components_match_jax(both, name):
    assert tuple(both["t_comps"]) == NAMES
    np.testing.assert_allclose(both["t_comps"][name].item(), float(both["j_comps"][name]), rtol=1e-5)
    assert both["t_comps2"][name].item() == both["t_comps"][name].item()


@pytest.mark.parametrize("name", NAMES)
def test_eval_step_components_match_jax(both, name):
    np.testing.assert_allclose(both["t_eval"][name].item(), float(both["j_eval"][name]), rtol=1e-5)


def _leaf_errors(both):
    got, want = both["t_grads"], both["j_grads"]
    assert set(got) == set(want)
    errs = {}
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        errs[k] = float(np.abs(got[k] - w).max()) / max(1.0, float(np.abs(w).max()))
    return errs


def test_every_gradient_leaf_matches_jax_grad(both):
    errs = _leaf_errors(both)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-4, f"worst leaf {worst}: {errs[worst]} of its scale"
    assert len(errs) > 150


@pytest.mark.parametrize("leaf", [
    "style_modeling/audio_encoder/lstm_d/l0_fwd_w_hh",  # through kernel C's plain version
    "style_modeling/audio_encoder/lstm_r/l1_bwd_w_ih",
    "style_modeling/augmentation_classifier_p/d_fc1/kernel",  # behind the GRL: true sign
    "style_modeling/audio_encoder/convs_p/conv_0/kernel",  # before the GRL: reversed
    "style_modeling/text_encoder/src_word_emb",
    "style_modeling/pitch_embedding/embedding",
    "postnet/bn_2/scale",
    "decoder/layer_0/pos_ffn/w_1/kernel",
])
def test_named_gradient_leaves(both, leaf):
    got, want = both["t_grads"][leaf], both["j_grads"][leaf]
    scale = float(np.abs(want).max())
    assert scale > 1e-6, "the leaf takes part in the loss"
    assert float(np.abs(got - want).max()) <= 1e-4 * max(1.0, scale)
    # a sign slip would double the error, far above rounding
    assert float(np.abs(got - want).max()) < 0.01 * scale


def test_update_matches_optax_where_the_gradient_is_not_noise(both):
    """One clip + Noam-Adam update from the same start, on the elements
    whose |grad| > 1e-6. The first update is u = lr * g/(|g| + eps) on the
    clipped gradient g, lr(1) = 2.5e-7, eps = 1e-9. The clip divides by a
    norm in the thousands, so |g| << eps and u is nearly linear in g with
    slope lr/eps: the two gradients' own difference (held to 1e-4 of the
    leaf's scale above) reappears in u times that slope. Allow exactly
    that, plus 0.1% of lr and two f32 ulps of the parameter u is added to.
    (The optimizer alone is held to 1e-6 on equal gradients in
    tests/test_torch_optimizer.py.)"""
    lr, eps = 256 ** -0.5 * 4000 ** -1.5, 1e-9
    norm = max(both["state2"].grad_norm.item(), 1.0)
    assert norm > 100
    assert set(both["t_new"]) == set(both["j_new"])
    moved = 0
    for k, want in both["j_new"].items():
        mask = np.abs(both["j_grads"][k]) > 1e-6
        got, old = both["t_new"][k], both["params"][k]
        dg = np.abs(both["t_grads"][k] - both["j_grads"][k]) / norm
        tol = 1.5 * lr * dg / eps + 1e-3 * lr + 2.4e-7 * np.abs(old)
        bad = (np.abs(got - want) > tol) & mask
        assert not bad.any(), (k, np.abs(got - want)[mask].max())
        # and the step itself is the expected size and direction
        step = (got - old)[mask & (np.abs(old) < 0.1)]
        g = (both["j_grads"][k] / norm)[mask & (np.abs(old) < 0.1)]
        assert np.all(np.abs(step + lr * g / (np.abs(g) + eps)) <= 0.05 * lr + tol.max())
        moved += int((got != old).sum())
    assert moved > 0 and both["state2"].step == 1
    assert np.isfinite(both["state2"].grad_norm.item()) and both["state2"].grad_norm.item() > 0
    for k, want in both["j_new_stats"].items():
        np.testing.assert_allclose(both["t_new_stats"][k], want, rtol=1e-4, atol=1e-4)


def test_acc_steps_is_refused(both):
    with pytest.raises(NotImplementedError, match="acc_steps"):
        create_train_state(both["cfg"].replace(acc_steps=2), torch.Generator().manual_seed(0),
                           device="cpu")


def test_fresh_state_follows_flax_initialisation(both):
    state = create_train_state(both["cfg"], torch.Generator().manual_seed(0), device="cpu")
    again = create_train_state(both["cfg"], torch.Generator().manual_seed(0), device="cpu")
    params, stats = (flatten_tree(t) for t in to_flax_tree(state.model))
    assert set(params) == set(both["params"])
    for k, v in flatten_tree(to_flax_tree(again.model)[0]).items():
        np.testing.assert_array_equal(v, params[k])
    for k, v in params.items():
        ref = both["params"][k]  # flax's own draw of the same leaf
        assert v.shape == ref.shape
        if k.endswith(("bias", "scale")) and "lstm" not in k:
            np.testing.assert_array_equal(v, ref)  # zeros and ones
        elif v.size >= 4096:  # same distribution: spread and range
            np.testing.assert_allclose(v.std(), ref.std(), rtol=0.1)
            assert np.abs(v).max() <= 1.05 * np.abs(ref).max() + 1e-6 or "emb" in k
    for k, v in stats.items():
        np.testing.assert_array_equal(v, 1.0 if k.endswith("var") else 0.0)


def test_loss_decreases_overfitting_tiny_batch(both):
    """30 updates on one batch, dropout on (reference tests/test_train.py)."""
    state = create_train_state(both["cfg"], torch.Generator().manual_seed(1), device="cpu")
    losses = []
    for i in range(30):
        _, comps = train_step(state, both["tb"], dropout_generator(0, i, "cpu"))
        losses.append(comps["total"].item())
    assert np.isfinite(losses).all() and state.step == 30
    assert np.mean(losses[-5:]) < np.mean(losses[:5]), losses


def test_save_restore_resumes_bit_for_bit(tmp_path):
    """Two steps, save, restore into a new trainer, step 3: parameters,
    BatchNorm statistics, Adam moments and components equal an
    uninterrupted run's bit for bit on the CPU, dropout on."""
    cfg = write_example_dataset(
        str(tmp_path / "data"), default_config().replace(batch_size=2, log_step=1, **REDUCED),
        8, seed=4, src_len_range=(5, 12), mel_len_range=(20, 48),
    )

    def run(name, max_steps, restore=0):
        seen = []
        tr = Trainer(cfg, device="cpu", ckpt_dir=str(tmp_path / name), log_dir=str(tmp_path / name))
        if restore:
            tr.restore(restore)
            assert tr.state.step == 2
        tr.fit(max_steps, on_step=lambda s, c: seen.append({k: v.item() for k, v in c.items()}),
               log=lambda _line: None)
        return tr, seen

    whole, seen_whole = run("whole", 3)
    first, _ = run("parts", 2)
    assert first.state.step == 2
    resumed, seen_resumed = run("parts", 3, restore=-1)
    assert resumed.state.step == whole.state.step == 3
    assert len(seen_whole) == 3 and seen_resumed == seen_whole[2:]
    a, b = whole.state.model.state_dict(), resumed.state.model.state_dict()
    assert set(a) == set(b) and any("running_var" in k for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    oa, ob = whole.state.optimizer.state_dict()["state"], resumed.state.optimizer.state_dict()["state"]
    for i in oa:
        assert torch.equal(oa[i]["exp_avg"], ob[i]["exp_avg"])
        assert torch.equal(oa[i]["exp_avg_sq"], ob[i]["exp_avg_sq"])
    lines = (tmp_path / "whole" / "train_metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3 and '"step": 3' in lines[-1]
