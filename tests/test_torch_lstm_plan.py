"""The launch plan of kernels B and C (``ops/lstm.py:lstm_plan``), on the
CPU: which instance each width runs, its threads, and how the dW
product splits its batch rows. Then the plain versions, which
the CPU runs, against the Pallas kernels in interpret mode at one width
of each instance class, forward and gradient.

The plan is chosen from Hp alone, so these tests hold what the card
will launch; the sources size each launch's shared memory, and
``tests/test_torch_cuda.py`` holds the kernels' own report of threads
and shared memory against the plan, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styler_tpu.ops.pallas_lstm import lstm_recurrence_pallas
from styler_tpu_torch.ops.lstm import (
    DW_TARGET_CTAS,
    INSTANCES,
    LSTMRecurrence,
    REGISTER_WIDTH_MAX,
    SHARED_WIDTH_MAX,
    force_lstm_plan,
    lstm_plan,
    pack_gates,
    pack_w_hh,
)
from tests.test_torch_golden_cache import torch_threads  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _unforced():
    force_lstm_plan()
    yield
    force_lstm_plan()


# (hp, recurrence instance, walk instance): the register file holds W = 96
# weights a thread; shared memory holds the padded weights up to W = 112
# for the walk (its dg buffer is larger) and W = 120 for the recurrence
@pytest.mark.parametrize("hp,rec,walk", [
    (1, "registers", "registers"), (8, "registers", "registers"), (9, "registers", "registers"),
    (80, "registers", "registers"), (96, "registers", "registers"),
    (97, "shared", "shared"), (104, "shared", "shared"), (112, "shared", "shared"),
    (113, "shared", "global"), (120, "shared", "global"),
    (121, "global", "global"), (128, "global", "global"), (256, "global", "global"),
])
def test_instance_follows_width(hp, rec, walk):
    plan = lstm_plan(hp, 8, 16)
    assert plan["width"] == -(-hp // 8) * 8
    assert plan["recurrence"]["instance"] == rec
    assert plan["backward"]["instance"] == walk
    for kernel in ("recurrence", "backward"):
        assert plan[kernel]["threads"] == 4 * plan["width"]
        assert plan[kernel]["ctas"] == 8 * 16


def test_every_width_fits_one_block():
    for hp in range(1, 257):
        plan = lstm_plan(hp, 8, 16)
        for kernel in ("recurrence", "backward"):
            assert plan[kernel]["threads"] <= 1024
            if plan[kernel]["instance"] == "shared":
                assert REGISTER_WIDTH_MAX < plan["width"] <= SHARED_WIDTH_MAX[kernel]
        assert plan["backward"]["dw_threads"] <= 512
        tj = plan["backward"]["dw_tile"][0]
        assert tj % 16 == 0 and tj * plan["backward"]["dw_grid"][1] >= hp


@pytest.mark.parametrize("hp", [0, 257, 1000])
def test_width_out_of_range_raises(hp):
    with pytest.raises(ValueError, match="Hp"):
        lstm_plan(hp)


def test_main_path_plan():
    """One BiLSTM layer of the audio encoder in training: 8 recurrences
    padded to Hp = 80, batch 16."""
    plan = lstm_plan(80, 8, 16)
    assert plan["recurrence"] == {"instance": "registers", "threads": 320, "ctas": 128}
    bwd = plan["backward"]
    assert (bwd["instance"], bwd["threads"], bwd["ctas"]) == ("registers", 320, 128)
    assert bwd["dw_tile"] == [80, 64] and bwd["dw_threads"] == 320
    assert (bwd["dw_splits"], bwd["dw_rows_per_split"]) == (16, 1)
    assert bwd["dw_grid"] == [5, 1, 128]


@pytest.mark.parametrize("S", [1, 8])
@pytest.mark.parametrize("hp", [8, 80, 128, 256])
@pytest.mark.parametrize("B", [1, 2, 3, 5, 16, 17, 64])
def test_dw_split_covers_every_batch_row_once(S, hp, B):
    bwd = lstm_plan(hp, S, B)["backward"]
    splits, rows = bwd["dw_splits"], bwd["dw_rows_per_split"]
    owned = [b for sp in range(splits) for b in range(sp * rows, min(B, (sp + 1) * rows))]
    assert owned == list(range(B))  # every split owns at least one row
    assert (splits - 1) * rows < B <= splits * rows
    n_xy = bwd["dw_grid"][0] * bwd["dw_grid"][1]
    assert bwd["dw_grid"][2] == S * splits
    # the split stops where the grid reaches its target or each split owns one row
    assert splits == B or n_xy * S * splits >= DW_TARGET_CTAS // 2


@pytest.mark.parametrize("instance", INSTANCES)
def test_forced_instance(instance):
    force_lstm_plan(instance=instance)
    plan = lstm_plan(80, 8, 16)
    assert plan["recurrence"]["instance"] == plan["backward"]["instance"] == instance
    assert plan["recurrence"]["threads"] == plan["backward"]["threads"] == 320


def test_forced_instance_that_does_not_fit_raises():
    force_lstm_plan(instance="registers")
    with pytest.raises(ValueError, match="register"):
        lstm_plan(104)
    force_lstm_plan(instance="shared")
    with pytest.raises(ValueError, match="shared memory"):
        lstm_plan(128)
    with pytest.raises(ValueError, match="instance"):
        force_lstm_plan(instance="tiles")


@pytest.mark.parametrize("splits,want", [(1, 1), (2, 2), (4, 4), (6, 6), (7, 6), (16, 16), (99, 16)])
def test_forced_dw_splits(splits, want):
    """A split given to the plan (timing only) is rounded to whole groups
    of rows: 7 splits of 16 rows are 6 groups of 3 (the last of 1)."""
    assert lstm_plan(80, 8, 16, dw_splits=splits)["backward"]["dw_splits"] == want
    with pytest.raises(ValueError, match="dw_splits"):
        lstm_plan(80, 8, 16, dw_splits=0)


def _pallas_problem(rng, B, T_, H):
    bound = 1.0 / np.sqrt(H)
    w_hh = rng.uniform(-bound, bound, (4 * H, H)).astype(np.float32)
    gates = rng.standard_normal((B, T_, 4 * H)).astype(np.float32)
    dh = rng.standard_normal((B, T_, H)).astype(np.float32)
    return gates, w_hh, dh


# one width of each instance class; the CPU runs the plain versions, which
# do not depend on the plan, so this holds the padding each class's Hp
# brings against the Pallas kernels
@pytest.mark.parametrize("H,hp", [(5, 8), (90, 97), (100, 128)])
def test_plain_matches_pallas_at_plan_widths(H, hp):
    gates, w_hh, dh = _pallas_problem(np.random.default_rng(H), 2, 5, H)

    def loss(g, w):
        return jnp.sum(lstm_recurrence_pallas(g, w, True) * jnp.asarray(dh))

    want_h = np.asarray(lstm_recurrence_pallas(jnp.asarray(gates), jnp.asarray(w_hh), True))
    want_dg, want_dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(gates), jnp.asarray(w_hh))
    g = pack_gates([torch.from_numpy(gates)], hp).requires_grad_()
    w = pack_w_hh([torch.from_numpy(w_hh)], hp).requires_grad_()
    dh_p = torch.zeros(1, 2, 5, hp)
    dh_p[0, ..., :H] = torch.from_numpy(dh)
    h = LSTMRecurrence.apply(g, w)
    (h * dh_p).sum().backward()
    np.testing.assert_allclose(h[0, ..., :H].detach().numpy(), want_h, atol=2e-5, rtol=1e-5)
    assert torch.all(h[0, ..., H:] == 0)
    dg = g.grad[0].reshape(2, 5, 4, hp)[..., :H].reshape(2, 5, 4 * H)
    np.testing.assert_allclose(dg.numpy(), np.asarray(want_dg), atol=1e-5, rtol=1e-4)
    # dw_t[j, k*hp + u] = dL/dw_hh[k*H + u, j]
    dw = w.grad[0].reshape(hp, 4, hp)[:H, :, :H].permute(1, 2, 0).reshape(4 * H, H)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), atol=1e-5, rtol=1e-4)
