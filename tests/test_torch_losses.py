"""The port's losses and gradient reversal against the JAX package's on the
same numpy inputs. Pure f32 reductions on both sides: 1e-6 relative."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from styler_tpu.ops.grl import gradient_reversal as j_grl
from styler_tpu.train import losses as j_losses
from styler_tpu_torch.ops.grl import gradient_reversal
from styler_tpu_torch.train import losses as t_losses

T = torch.from_numpy
B, L, M, C = 3, 7, 20, 80
NAMES = ("total", "mel", "mel_postnet", "mel_noisy", "mel_postnet_noisy",
         "duration", "f0", "energy", "dat_clean", "dat_aug")


def _log_softmax(a):
    a = a - a.max(-1, keepdims=True)
    return (a - np.log(np.exp(a).sum(-1, keepdims=True))).astype(np.float32)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(5)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    src_len, mel_len = np.array([7, 4, 1]), np.array([20, 13, 5])
    out = dict(
        mel=f(B, M, C), mel_noisy=f(B, M, C), mel_postnet=f(B, M, C), mel_postnet_noisy=f(B, M, C),
        log_d_prediction=f(B, L), p_prediction=f(B, M) * 100, e_prediction=f(B, M) * 30,
        src_mask=np.arange(L)[None] >= src_len[:, None],
        mel_mask=np.arange(M)[None] >= mel_len[:, None],
        dat_posteriors=tuple(_log_softmax(f(B, 2)) for _ in range(3)),
    )
    args = dict(
        mel_target=f(B, M, C), mel_aug=f(B, M, C), log_d_target=f(B, L),
        p_target=f(B, M) * 100, e_target=f(B, M) * 30,
        dat_posteriors_aug=tuple(_log_softmax(f(B, 2)) for _ in range(3)),
    )
    return out, args


def _both(case, dat_weight):
    out, args = case
    to_j = lambda v: tuple(map(jnp.asarray, v)) if isinstance(v, tuple) else jnp.asarray(v)  # noqa: E731
    to_t = lambda v: tuple(map(T, v)) if isinstance(v, tuple) else T(v)  # noqa: E731
    want = j_losses.styler_loss(
        SimpleNamespace(**{k: to_j(v) for k, v in out.items()}),
        **{k: to_j(v) for k, v in args.items()}, dat_weight=dat_weight,
    )
    got = t_losses.styler_loss(
        SimpleNamespace(**{k: to_t(v) for k, v in out.items()}),
        **{k: to_t(v) for k, v in args.items()}, dat_weight=dat_weight,
    )
    return got, want


@pytest.mark.parametrize("name", NAMES)
def test_components_match_jax(case, name):
    (_, got), (_, want) = _both(case, 1.0)
    assert tuple(got) == NAMES == tuple(want)
    np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=1e-6)


def test_total_with_dat_weight(case):
    (total, comps), (j_total, _) = _both(case, 0.25)
    np.testing.assert_allclose(total.item(), float(j_total), rtol=1e-6)
    rest = sum(comps[k].item() for k in NAMES[1:8])
    np.testing.assert_allclose(
        total.item(), rest + 0.25 * (comps["dat_clean"].item() + comps["dat_aug"].item()),
        rtol=1e-6,
    )


@pytest.mark.parametrize("fn", ["masked_mse", "masked_mae"])
def test_masked_means_match_jax_and_ignore_padding(case, fn):
    out, args = case
    valid = ~out["mel_mask"]
    pred, target = out["p_prediction"], args["p_target"]
    want = float(getattr(j_losses, fn)(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(valid)))
    got = getattr(t_losses, fn)(T(pred), T(target), T(valid)).item()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    noisy = pred.copy()
    noisy[~valid] += 1e3  # padding must not count
    np.testing.assert_allclose(getattr(t_losses, fn)(T(noisy), T(target), T(valid)).item(), got,
                               rtol=1e-6)
    # an all-padding mask divides by 1, not by 0
    assert getattr(t_losses, fn)(T(pred), T(target), T(np.zeros_like(valid))).item() == 0.0


def test_nll_loss_matches_torch_nllloss_and_jax():
    logp = np.log(np.array([[0.7, 0.3], [0.2, 0.8], [0.5, 0.5]], dtype=np.float32))
    labels = np.array([0, 1, 1])
    golden = torch.nn.NLLLoss()(T(logp), T(labels)).item()
    np.testing.assert_allclose(t_losses.nll_loss(T(logp), T(labels)).item(), golden, rtol=1e-6)
    np.testing.assert_allclose(
        t_losses.nll_loss(T(logp), T(labels)).item(),
        float(j_losses.nll_loss(jnp.asarray(logp), jnp.asarray(labels))), rtol=1e-6,
    )


@pytest.mark.parametrize("alpha", [1.0, 0.3])
def test_gradient_reversal(alpha):
    """Identity forward, -alpha * g backward, as the JAX custom_vjp."""
    rng = np.random.default_rng(1)
    x_np = rng.standard_normal((4, 5)).astype(np.float32)
    w_np = rng.standard_normal((4, 5)).astype(np.float32)
    x = T(x_np).requires_grad_()
    y = gradient_reversal(x, alpha)
    np.testing.assert_array_equal(y.detach().numpy(), x_np)
    (y * T(w_np)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), -alpha * w_np, rtol=1e-7)
    want = jax.grad(lambda a: jnp.sum(j_grl(a, alpha) * w_np))(jnp.asarray(x_np))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6)
