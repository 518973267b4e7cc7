"""Gradients of the port's LSTM recurrence (kernels B and C as the CPU runs
them: their plain versions inside ``LSTMRecurrence``) against the JAX
package: ``jax.grad`` through the ``lax.scan`` recurrence, through the
Pallas kernel pair in interpret mode, and through the layer-fused
audio-encoder BiLSTMs with ragged lengths.

Both sides are exact f32 with sums in another order; the tolerance is the
reference's own for its BPTT kernel against the scan (atol = rtol = 1e-4).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from styler_tpu.ops.pallas_lstm import lstm_recurrence_pallas
from styler_tpu.ops.recurrent import _lstm_scan, fused_bilstm_branches as j_fused
from styler_tpu_torch.ops.lstm import (
    LSTMRecurrence,
    lstm_backward_plain,
    lstm_recurrence_plain,
    pack_gates,
    pack_w_hh,
)
from styler_tpu_torch.ops.recurrent import flip_padded, fused_bilstm_branches as t_fused

T = torch.from_numpy
SHAPES = [(2, 12, 8, 8), (2, 9, 16, 24), (3, 33, 80, 96)]


def _setup(rng, B, T_, H, In):
    bound = 1.0 / np.sqrt(H)
    w_ih = rng.uniform(-bound, bound, (4 * H, In)).astype(np.float32)
    w_hh = rng.uniform(-bound, bound, (4 * H, H)).astype(np.float32)
    b = rng.uniform(-bound, bound, (2, 4 * H)).astype(np.float32)
    x = rng.standard_normal((B, T_, In)).astype(np.float32)
    gates = (x.astype(np.float64) @ w_ih.T.astype(np.float64) + b[0] + b[1]).astype(np.float32)
    cot = rng.standard_normal((B, T_, H)).astype(np.float32)
    return x, w_hh, gates, cot


def _port_grads(gates, w_hh, cot, hp=None):
    """d(gates) [B, T, 4H] and d(w_hh) [4H, H] through pack -> Function."""
    H = w_hh.shape[1]
    g = T(gates).requires_grad_()
    w = T(w_hh).requires_grad_()
    h = LSTMRecurrence.apply(pack_gates([g], hp or H), pack_w_hh([w], hp or H))
    (h[0, ..., :H] * T(cot)).sum().backward()
    return g.grad.numpy(), w.grad.numpy()


@pytest.mark.parametrize("B,T_,H,In", SHAPES)
def test_gradients_match_jax_scan(B, T_, H, In):
    x, w_hh, gates, cot = _setup(np.random.default_rng(B * 100 + H), B, T_, H, In)
    dg_ref, dw_ref = jax.grad(
        lambda g, w: jnp.sum(_lstm_scan(jnp.asarray(x), w, g) * cot), argnums=(0, 1)
    )(jnp.asarray(gates), jnp.asarray(w_hh))
    dg, dw = _port_grads(gates, w_hh, cot)
    np.testing.assert_allclose(dg, np.asarray(dg_ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(dw, np.asarray(dw_ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("B,T_,H,In", SHAPES)
def test_gradients_match_pallas_interpret(B, T_, H, In):
    x, w_hh, gates, cot = _setup(np.random.default_rng(B * 100 + H + 1), B, T_, H, In)
    dg_ref, dw_ref = jax.grad(
        lambda g, w: jnp.sum(lstm_recurrence_pallas(g, w, True) * cot), argnums=(0, 1)
    )(jnp.asarray(gates), jnp.asarray(w_hh))
    dg, dw = _port_grads(gates, w_hh, cot)
    np.testing.assert_allclose(dg, np.asarray(dg_ref), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(dw, np.asarray(dw_ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S,B,T_,hp", [(1, 2, 12, 8), (8, 3, 21, 16)])
def test_backward_plain_matches_autograd_of_forward_plain(S, B, T_, hp):
    """The explicit reverse loop against torch.autograd through the plain
    forward: two independent derivations of the same gradient."""
    rng = np.random.default_rng(S + T_)
    g = T(rng.standard_normal((S, B, T_, 4 * hp)).astype(np.float32)).requires_grad_()
    w = T(rng.uniform(-0.3, 0.3, (S, hp, 4 * hp)).astype(np.float32)).requires_grad_()
    dh = T(rng.standard_normal((S, B, T_, hp)).astype(np.float32))
    dg_auto, dw_auto = torch.autograd.grad((lstm_recurrence_plain(g, w) * dh).sum(), (g, w))
    with torch.no_grad():
        h, c, acts = lstm_recurrence_plain(g, w, save=True)
        dg, dw = lstm_backward_plain(dh, acts, c, h, w)
    np.testing.assert_allclose(dg.numpy(), dg_auto.numpy(), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(dw.numpy(), dw_auto.numpy(), atol=1e-5, rtol=1e-4)


def test_function_saves_only_when_a_gradient_is_wanted():
    rng = np.random.default_rng(0)
    g = T(rng.standard_normal((1, 2, 5, 16)).astype(np.float32))
    w = T(rng.uniform(-0.3, 0.3, (1, 4, 16)).astype(np.float32))
    assert LSTMRecurrence.apply(g, w).grad_fn is None
    h = LSTMRecurrence.apply(g.clone().requires_grad_(), w)
    assert h.grad_fn is not None
    with torch.no_grad():
        assert LSTMRecurrence.apply(g.clone().requires_grad_(), w).grad_fn is None
    np.testing.assert_array_equal(h.detach().numpy(), lstm_recurrence_plain(g, w).numpy())


def test_zero_padding_to_wider_hidden_gives_zero_gradient():
    """Padded to Hp = 80 (as the layer-fused launch pads the H = 64 necks)
    the gradients of the real units are unchanged up to the sum order, and
    the padded units of d(gates) and dW are exactly 0."""
    x, w_hh, gates, cot = _setup(np.random.default_rng(7), 2, 19, 8, 8)
    dg_n, dw_n = _port_grads(gates, w_hh, cot)
    dg_w, dw_w = _port_grads(gates, w_hh, cot, hp=80)
    np.testing.assert_allclose(dg_w, dg_n, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(dw_w, dw_n, atol=1e-6, rtol=1e-5)
    g = pack_gates([T(gates)], 80)
    w = pack_w_hh([T(w_hh)], 80)
    dh = torch.zeros(1, 2, 19, 80)
    dh[0, ..., :8] = T(cot)
    h, c, acts = lstm_recurrence_plain(g, w, save=True)
    dg, dw = lstm_backward_plain(dh, acts, c, h, w)
    assert torch.all(dg.reshape(1, 2, 19, 4, 80)[..., 8:] == 0)
    assert torch.all(dw[0, 8:] == 0) and torch.all(dw.reshape(1, 80, 4, 80)[..., 8:] == 0)


def _branch_params(rng, in_dims, hiddens, n_layers=2):
    out = []
    for In, H in zip(in_dims, hiddens):
        bound = 1.0 / np.sqrt(H)
        layers, d_in = [], In
        for _ in range(n_layers):
            layers.append({
                d: {
                    "w_ih": rng.uniform(-bound, bound, (4 * H, d_in)).astype(np.float32),
                    "w_hh": rng.uniform(-bound, bound, (4 * H, H)).astype(np.float32),
                    "b_ih": rng.uniform(-bound, bound, (4 * H,)).astype(np.float32),
                    "b_hh": rng.uniform(-bound, bound, (4 * H,)).astype(np.float32),
                }
                for d in ("fwd", "bwd")
            })
            d_in = 2 * H
        out.append(layers)
    return out


@pytest.fixture(scope="module")
def fused_grads():
    """Gradients of sum(out * cotangent) over the four bottleneck BiLSTMs
    (H = 80/64/64/64, two layers, ragged lengths incl. 1) w.r.t. every
    input and parameter, on both sides."""
    rng = np.random.default_rng(31)
    in_dims, hiddens = (32, 40, 40, 32), (80, 64, 64, 64)
    B, T_ = 3, 24
    lengths = np.asarray([24, 9, 1])
    params = _branch_params(rng, in_dims, hiddens)
    xs = [rng.standard_normal((B, T_, In)).astype(np.float32) for In in in_dims]
    cots = [rng.standard_normal((B, T_, 2 * H)).astype(np.float32) for H in hiddens]

    def j_loss(p, x):
        outs = j_fused(p, x, jnp.asarray(lengths))
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots))

    jp, jx = jax.grad(j_loss, argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), [jnp.asarray(x) for x in xs]
    )
    tp = [[{d: {k: T(v).requires_grad_() for k, v in lp[d].items()} for d in lp} for lp in p]
          for p in params]
    tx = [T(x).requires_grad_() for x in xs]
    outs = t_fused(tp, tx, T(lengths))
    sum((o * T(c)).sum() for o, c in zip(outs, cots)).backward()
    return jax.tree_util.tree_map(np.asarray, (jp, jx)), (tp, tx), lengths


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, atol=1e-4 * scale, rtol=1e-4)


@pytest.mark.parametrize("kind", ["w_ih", "w_hh", "b_ih", "b_hh"])
def test_fused_branches_parameter_gradients_match_jax(fused_grads, kind):
    (jp, _), (tp, _), _ = fused_grads
    for b in range(4):
        for layer in range(2):
            for d in ("fwd", "bwd"):
                _close(tp[b][layer][d][kind].grad.numpy(), jp[b][layer][d][kind])


def test_fused_branches_input_gradients_match_jax(fused_grads):
    (_, jx), (_, tx), _ = fused_grads
    for got, want in zip(tx, jx):
        _close(got.grad.numpy(), want)


def test_flip_padded_gradient_is_a_flip_with_zero_padding():
    """The backward of the gather is a scatter-add: the gradient of the
    valid rows is the flipped cotangent, the padded rows get exactly 0."""
    rng = np.random.default_rng(3)
    lengths = np.asarray([7, 3, 1])
    x = T(rng.standard_normal((3, 7, 5)).astype(np.float32)).requires_grad_()
    cot = rng.standard_normal((3, 7, 5)).astype(np.float32)
    (flip_padded(x, T(lengths)) * T(cot)).sum().backward()
    for b, n in enumerate(lengths):
        np.testing.assert_array_equal(x.grad.numpy()[b, :n], cot[b, :n][::-1])
        assert np.all(x.grad.numpy()[b, n:] == 0)
