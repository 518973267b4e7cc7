"""The port's LSTM recurrence (kernel B's plain version, as the CPU runs it)
against the JAX package: the Pallas kernel in interpret mode, the
``lax.scan`` recurrence, and the layer-fused audio-encoder BiLSTMs.

Both sides are exact f32 with sums in another order; over up to 33 steps
the outputs agree to 2e-5 (the Pallas tests' own bound against the scan).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from styler_tpu.ops.pallas_lstm import lstm_recurrence_pallas
from styler_tpu.ops.recurrent import _lstm_scan, fused_bilstm_branches as j_fused
from styler_tpu_torch.ops.lstm import lstm_recurrence, pack_gates, pack_w_hh
from styler_tpu_torch.ops.recurrent import fused_bilstm_branches as t_fused
from tests.test_torch_golden_cache import torch_threads  # noqa: F401 (autouse)

T = torch.from_numpy


def _setup(rng, B, T_, H, In):
    bound = 1.0 / np.sqrt(H)
    w_ih = rng.uniform(-bound, bound, (4 * H, In)).astype(np.float32)
    w_hh = rng.uniform(-bound, bound, (4 * H, H)).astype(np.float32)
    b = rng.uniform(-bound, bound, (2, 4 * H)).astype(np.float32)
    x = rng.standard_normal((B, T_, In)).astype(np.float32)
    gates = (x.astype(np.float64) @ w_ih.T.astype(np.float64) + b[0] + b[1]).astype(np.float32)
    return x, w_hh, gates


def _port_single(gates, w_hh, hp=None):
    H = w_hh.shape[1]
    hp = hp or H
    h = lstm_recurrence(pack_gates([T(gates)], hp), pack_w_hh([T(w_hh)], hp))
    return h[0, ..., :H].numpy()


@pytest.mark.parametrize("B,T_,H,In", [(2, 16, 8, 12), (3, 33, 80, 96), (1, 7, 64, 64)])
def test_recurrence_matches_pallas_interpret(B, T_, H, In):
    x, w_hh, gates = _setup(np.random.default_rng(B * 100 + H), B, T_, H, In)
    want = np.asarray(lstm_recurrence_pallas(jnp.asarray(gates), jnp.asarray(w_hh), True))
    np.testing.assert_allclose(_port_single(gates, w_hh), want, atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("B,T_,H,In", [(2, 16, 8, 12), (3, 33, 80, 96), (1, 7, 64, 64)])
def test_recurrence_matches_scan(B, T_, H, In):
    x, w_hh, gates = _setup(np.random.default_rng(B * 100 + H + 1), B, T_, H, In)
    want = np.asarray(_lstm_scan(jnp.asarray(x), jnp.asarray(w_hh), jnp.asarray(gates)))
    np.testing.assert_allclose(_port_single(gates, w_hh), want, atol=2e-5, rtol=1e-5)


def test_zero_padding_to_wider_hidden():
    """Padding a recurrence to a wider Hp (as the layer-fused launch does)
    leaves its outputs unchanged up to the sum order of the wider matmul,
    and the padded units at exactly 0."""
    x, w_hh, gates = _setup(np.random.default_rng(7), 2, 19, 8, 8)
    narrow = _port_single(gates, w_hh)
    h = lstm_recurrence(pack_gates([T(gates)], 80), pack_w_hh([T(w_hh)], 80))
    np.testing.assert_allclose(h[0, ..., :8].numpy(), narrow, atol=1e-6, rtol=0)
    assert torch.all(h[0, ..., 8:] == 0)


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


@pytest.mark.parametrize("lengths", [[24, 9, 1], [24, 24, 24]])
def test_fused_branches_match_jax(lengths):
    """The audio encoder's four bottleneck BiLSTMs (H = 80/64/64/64, two
    layers) with ragged lengths: backward directions flip within each
    valid length."""
    rng = np.random.default_rng(sum(lengths))
    in_dims, hiddens = (32, 40, 40, 32), (80, 64, 64, 64)
    params = _branch_params(rng, in_dims, hiddens)
    xs = [rng.standard_normal((3, 24, In)).astype(np.float32) for In in in_dims]
    lengths = np.asarray(lengths)
    want = j_fused(
        jax.tree_util.tree_map(jnp.asarray, params),
        [jnp.asarray(x) for x in xs], jnp.asarray(lengths),
    )
    got = t_fused(
        [[{d: {k: T(v) for k, v in lp[d].items()} for d in lp} for lp in p] for p in params],
        [T(x) for x in xs], T(lengths),
    )
    for g, w, H in zip(got, want, hiddens):
        assert g.shape == (3, 24, 2 * H)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=1e-5)
