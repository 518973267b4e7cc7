"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and carries the ``cuda`` marker; the
``cuda_device`` fixture skips them where there is none. This file imports
no JAX, so on a machine without JAX run it with the repository's conftest
switched off:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from styler_tpu_torch.core.device import resolve_device
from styler_tpu_torch.ops.lstm import (
    lstm_recurrence,
    lstm_recurrence_plain,
    pack_gates,
    pack_w_hh,
)
from styler_tpu_torch.ops.resblock import fused_resblock_stage, resblock_stage_plain

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return resolve_device(None)  # also switches TF32 off


def _branch_params(rng, kernel_sizes, n_dil, C, device):
    out = []
    for k in kernel_sizes:
        w1, w2 = (
            torch.from_numpy(
                (rng.standard_normal((n_dil, k, C, C)) * 0.05).astype(np.float32)
            ).to(device)
            for _ in range(2)
        )
        b1, b2 = (
            torch.from_numpy(
                (rng.standard_normal((n_dil, C)) * 0.01).astype(np.float32)
            ).to(device)
            for _ in range(2)
        )
        out.append((w1, b1, w2, b2))
    return out


# f32: both sum exact f32 products in another order, so 1e-5 of the output
# scale. bf16: identical bf16-rounded inputs and f32 sums; an order change
# can flip a bf16 rounding of a carry-fed conv input, so allow a few bf16
# ulps of the output scale.
@pytest.mark.parametrize(
    "dtype,B,T,C,kernel_sizes,dilations,tol",
    [
        (torch.float32, 2, 64, 8, (3, 5), (1, 2), 1e-5),
        (torch.float32, 2, 200, 96, (3, 7, 11), (1, 3, 5), 1e-5),
        (torch.bfloat16, 2, 200, 96, (3, 7, 11), (1, 3, 5), 3e-2),
        (torch.bfloat16, 1, 1000, 256, (3, 7, 11), (1, 3, 5), 3e-2),
        (torch.bfloat16, 3, 333, 40, (3, 7, 11), (1, 3, 5), 3e-2),
        (torch.bfloat16, 1, 128, 32, (3,), (1, 2), 3e-2),
        (torch.float32, 1, 333, 32, (3, 7, 11), (1, 3, 5), 1e-5),
    ],
)
def test_resblock_kernel_matches_plain(
    cuda_device, dtype, B, T, C, kernel_sizes, dilations, tol
):
    rng = np.random.default_rng(0)
    bp = _branch_params(rng, kernel_sizes, len(dilations), C, cuda_device)
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32))
    x = x.to(cuda_device, dtype)
    before = fused_resblock_stage.launches
    got = fused_resblock_stage(x, bp, kernel_sizes, dilations)
    torch.cuda.synchronize()
    assert fused_resblock_stage.launches - before == 2 * len(kernel_sizes) * len(dilations)
    want = resblock_stage_plain(x, bp, kernel_sizes, dilations)
    assert got.dtype == dtype and got.shape == x.shape
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(scale, 1.0), (err, scale)


def test_resblock_kernel_rejects_bad_input(cuda_device):
    rng = np.random.default_rng(1)
    bp = _branch_params(rng, (3,), 1, 8, cuda_device)
    with pytest.raises(TypeError):
        fused_resblock_stage(
            torch.zeros(1, 16, 8, device=cuda_device, dtype=torch.float16), bp, (3,), (1,)
        )
    with pytest.raises(ValueError):
        fused_resblock_stage(
            torch.zeros(1, 8, 16, device=cuda_device).transpose(1, 2), bp, (3,), (1,)
        )
    bp6 = _branch_params(rng, (3,), 1, 6, cuda_device)
    with pytest.raises(ValueError, match="C % 8"):
        fused_resblock_stage(
            torch.zeros(1, 16, 6, device=cuda_device, dtype=torch.bfloat16), bp6, (3,), (1,)
        )


@pytest.mark.parametrize("B,T,hiddens", [(1, 256, (80, 64, 64, 64)), (3, 33, (8, 80))])
def test_lstm_kernel_matches_plain(cuda_device, B, T, hiddens):
    rng = np.random.default_rng(2)
    gates, w_hh = [], []
    for H in hiddens:
        for _ in range(2):  # two directions
            gates.append(torch.from_numpy(rng.standard_normal((B, T, 4 * H)).astype(np.float32)))
            bound = 1.0 / np.sqrt(H)
            w_hh.append(
                torch.from_numpy(rng.uniform(-bound, bound, (4 * H, H)).astype(np.float32))
            )
    hp = max(hiddens)
    g = pack_gates(gates, hp).to(cuda_device)
    w = pack_w_hh(w_hh, hp).to(cuda_device)
    before = lstm_recurrence.launches
    got = lstm_recurrence(g, w)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches - before == 1
    want = lstm_recurrence_plain(g, w)
    assert got.shape == (len(gates), B, T, hp)
    # exact f32 on both sides, sums in another order over up to 256 steps
    assert (got - want).abs().max().item() < 2e-5
    for s, H in enumerate(h for h in hiddens for _ in range(2)):
        assert torch.all(got[s, ..., H:] == 0.0)  # padded units stay exactly 0
