"""The port's Noam schedule, global-norm clip and Adam against the JAX
package's optax chain, on the same numpy gradients."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from styler_tpu.core.config import default_config as j_config
from styler_tpu.train.optimizer import make_optimizer, noam_schedule as j_noam
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.train.optimizer import NoamAdam, clip_by_global_norm, noam_schedule

T = torch.from_numpy
SHAPES = {"a": (7, 5), "b": (5,), "c": (3, 4, 2)}


@pytest.mark.parametrize("step", [1, 4000, 560000])
def test_noam_golden(step):
    """Golden values of the reference formula (optimizer.py:21-32) at the
    1-indexed step; the JAX schedule takes the 0-indexed count."""
    golden = 256 ** -0.5 * min(step ** -0.5, 4000 ** -1.5 * step)
    got = noam_schedule(256, 4000)(step)
    np.testing.assert_allclose(got, golden, rtol=1e-12)
    np.testing.assert_allclose(got, float(j_noam(256, 4000)(step - 1)), rtol=1e-6)


def test_noam_peaks_at_warmup():
    sched = noam_schedule(256, 4000)
    assert sched(100) < sched(4000) > sched(100000)


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES.items()}


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
def test_clip_matches_optax_below_and_above_the_threshold(scale):
    grads = _tree(np.random.default_rng(2), scale)
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads.values()))
    assert (norm < 1.0) == (scale == 0.01)
    want, _ = optax.clip_by_global_norm(1.0).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState()
    )
    got = [T(g.copy()) for g in grads.values()]
    got_norm = clip_by_global_norm(got, 1.0)
    np.testing.assert_allclose(got_norm.item(), norm, rtol=1e-6)
    for g, k in zip(got, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-12)
    if scale == 0.01:  # below the threshold the gradients pass untouched
        for g, k in zip(got, grads):
            np.testing.assert_array_equal(g.numpy(), grads[k])


def test_three_adam_updates_match_optax():
    """clip -> Adam(0.9, 0.98, eps 1e-9) at the Noam rate, three updates on
    a small tree with the same numpy gradients (large ones, so the clip is
    active, and a leaf of tiny ones, where eps matters)."""
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = [_tree(rng, s) for s in (5.0, 0.5, 2.0)]
    for g in grads:
        g["b"] *= 1e-7

    tx = make_optimizer(j_config())
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = [torch.nn.Parameter(T(v.copy())) for v in params.values()]
    opt = NoamAdam(tp, default_config())
    for i, g in enumerate(grads):
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, v in zip(tp, g.values()):
            p.grad = T(v.copy())
        opt.update(i + 1)
        for p, k in zip(tp, params):
            # the update, not only the parameter, agrees to 1e-6 of its size
            want = np.asarray(jp[k])
            step = np.abs(want - params[k]).max()
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6, atol=1e-6 * step)


def test_update_refuses_a_parameter_without_gradient():
    p = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))]
    opt = NoamAdam(p, default_config())
    p[0].grad = torch.ones(3)
    with pytest.raises(RuntimeError, match="no gradient"):
        opt.update(1)
