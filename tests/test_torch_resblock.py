"""The port's resblock stage (kernel A's plain version, as the CPU runs it)
against the JAX package: the Pallas stage kernel in interpret mode (f32
and bf16) and the flax ``ResBlock1`` mean (f32).

f32: both sides are exact f32 with sums in another order -> 1e-5.
bf16: both round every conv input to bf16, sum in f32 and keep the carry
in f32 (the Pallas kernel's semantics); an order change can flip a bf16
rounding that then propagates, so the bound is 2% of the output scale
(measured 0 and 0.17%).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from styler_tpu.ops.pallas_resblock import branch_params_from_variables, fused_resblock_stage
from styler_tpu.vocoder.hifigan import ResBlock1
from styler_tpu_torch.ops.resblock import fused_resblock_stage as port_stage
from styler_tpu_torch.ops.resblock import resblock_stage_plain
from tests.test_torch_golden_cache import torch_threads  # noqa: F401 (autouse)


def _make_params(rng, kernel_sizes, dilations, C):
    params = {}
    for j, rk in enumerate(kernel_sizes):
        blk = {}
        for c in range(len(dilations)):
            for group in ("convs1", "convs2"):
                blk[f"{group}_{c}"] = {
                    "kernel": (rng.standard_normal((rk, C, C)) * 0.05).astype(np.float32),
                    "bias": (rng.standard_normal(C) * 0.01).astype(np.float32),
                }
        params[f"resblocks_0_{j}"] = blk
    return params


def _port_branch_params(params, n_branches):
    return [
        tuple(torch.from_numpy(np.array(a)) for a in bp)
        for bp in branch_params_from_variables(params, 0, n_branches)
    ]


# (kernel_sizes, dilations, C, T, block_t): the Pallas tests' small shape,
# and the production topology at a T the Pallas kernel splits into 4 blocks
CASES = [
    ((3, 5), (1, 2), 8, 64, 0),
    ((3, 7, 11), (1, 3, 5), 32, 512, 32),
]


@pytest.mark.parametrize("kernel_sizes,dilations,C,T_,block_t", CASES)
def test_stage_f32_matches_pallas_interpret(kernel_sizes, dilations, C, T_, block_t):
    rng = np.random.default_rng(C)
    params = _make_params(rng, kernel_sizes, dilations, C)
    x = rng.standard_normal((2, T_, C)).astype(np.float32)
    want = np.asarray(fused_resblock_stage(
        jnp.asarray(x), branch_params_from_variables(params, 0, len(kernel_sizes)),
        kernel_sizes=kernel_sizes, dilations=dilations, block_t=block_t, interpret=True,
    ))
    got = port_stage(torch.from_numpy(x), _port_branch_params(params, len(kernel_sizes)),
                     kernel_sizes, dilations)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel_sizes,dilations,C,T_,block_t", CASES)
def test_stage_bf16_matches_pallas_interpret(kernel_sizes, dilations, C, T_, block_t):
    rng = np.random.default_rng(C + 1)
    params = _make_params(rng, kernel_sizes, dilations, C)
    x = rng.standard_normal((2, T_, C)).astype(np.float32)
    want = np.asarray(fused_resblock_stage(
        jnp.asarray(x, jnp.bfloat16), branch_params_from_variables(params, 0, len(kernel_sizes)),
        kernel_sizes=kernel_sizes, dilations=dilations, block_t=block_t, interpret=True,
    ).astype(jnp.float32))
    got = port_stage(torch.from_numpy(x).to(torch.bfloat16),
                     _port_branch_params(params, len(kernel_sizes)), kernel_sizes, dilations)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max(), err


@pytest.mark.parametrize("kernel_sizes,dilations,C,T_,block_t", CASES)
def test_stage_f32_matches_flax_resblocks(kernel_sizes, dilations, C, T_, block_t):
    rng = np.random.default_rng(C + 2)
    params = _make_params(rng, kernel_sizes, dilations, C)
    x = rng.standard_normal((1, T_, C)).astype(np.float32)
    want = None
    for j, rk in enumerate(kernel_sizes):
        out = ResBlock1(C, rk, tuple(dilations), dtype=jnp.float32).apply(
            {"params": params[f"resblocks_0_{j}"]}, jnp.asarray(x)
        )
        want = out if want is None else want + out
    want = np.asarray(want / len(kernel_sizes))
    got = resblock_stage_plain(torch.from_numpy(x), _port_branch_params(params, len(kernel_sizes)),
                               kernel_sizes, dilations)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_counts_no_launch():
    """On CPU tensors the wrapper runs the plain version and launches nothing."""
    rng = np.random.default_rng(3)
    params = _make_params(rng, (3,), (1,), 4)
    before = port_stage.launches
    port_stage(torch.zeros(1, 8, 4), _port_branch_params(params, 1), (3,), (1,))
    assert port_stage.launches == before
