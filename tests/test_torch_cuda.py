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
    LSTMRecurrence,
    lstm_backward,
    lstm_backward_plain,
    lstm_recurrence,
    lstm_recurrence_plain,
    pack_gates,
    pack_w_hh,
)
from styler_tpu_torch.ops.resblock import (
    fused_resblock_stage,
    quantize_branch_params,
    resblock_stage_int8,
    resblock_stage_int8_plain,
    resblock_stage_plain,
)

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


# int8: both pick the same integers (same f32 scales, round half to even)
# and sum them exactly; the f32 epilogue repeats the same roundings, so an
# f32 output agrees to f32 rounding. A bf16 output may round one f32 ulp
# apart to the other bf16 neighbour: 2 bf16 ulps (2^-7) of the scale.
INT8_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


@pytest.mark.parametrize(
    "dtype,B,T,C",
    [
        (torch.bfloat16, 2, 1024, 256),
        (torch.bfloat16, 2, 2048, 128),
        (torch.bfloat16, 1, 4096, 64),
        (torch.bfloat16, 2, 8192, 32),
        (torch.float32, 1, 1000, 256),
        (torch.float32, 3, 333, 32),  # ragged T: a partial last tile
        (torch.float32, 1, 77, 48),
    ],
)
def test_int8_kernel_matches_plain(cuda_device, dtype, B, T, C):
    rng = np.random.default_rng(C)
    ks, dils = (3, 7, 11), (1, 3, 5)
    q = quantize_branch_params(_branch_params(rng, ks, len(dils), C, cuda_device))
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(cuda_device, dtype)
    before = (resblock_stage_int8.launches, fused_resblock_stage.launches)
    got = fused_resblock_stage(x, q, ks, dils, quantize=True)
    torch.cuda.synchronize()
    assert resblock_stage_int8.launches - before[0] == 18
    assert fused_resblock_stage.launches == before[1]
    want = resblock_stage_int8_plain(x, q, ks, dils)
    assert got.dtype == dtype and got.shape == x.shape and torch.isfinite(got).all()
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= INT8_TOL[dtype] * max(scale, 1.0), (err, scale)


def test_int8_kernel_is_deterministic(cuda_device):
    rng = np.random.default_rng(7)
    q = quantize_branch_params(_branch_params(rng, (3, 7, 11), 3, 64, cuda_device))
    x = torch.from_numpy(rng.standard_normal((2, 3000, 64)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    a = resblock_stage_int8(x, q)
    b = resblock_stage_int8(x, q)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_int8_kernel_rejects_bad_input(cuda_device):
    rng = np.random.default_rng(8)
    q = quantize_branch_params(_branch_params(rng, (3,), 1, 16, cuda_device))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        resblock_stage_int8(torch.zeros(1, 16, 16, device=cuda_device, dtype=torch.float16),
                            q, (3,), (1,))
    with pytest.raises(ValueError, match="contiguous"):
        resblock_stage_int8(torch.zeros(1, 16, 16, device=cuda_device).transpose(1, 2), q, (3,), (1,))
    q8 = quantize_branch_params(_branch_params(rng, (3,), 1, 8, cuda_device))
    with pytest.raises(ValueError, match="C % 16"):
        resblock_stage_int8(torch.zeros(1, 16, 8, device=cuda_device), q8, (3,), (1,))
    with pytest.raises(ValueError, match=r"int8 \[n_dil, k, C, C\]"):
        resblock_stage_int8(torch.zeros(1, 16, 16, device=cuda_device), q, (5,), (1,))
    with pytest.raises(TypeError, match="Int8Branch"):
        resblock_stage_int8(torch.zeros(1, 16, 16, device=cuda_device),
                            _branch_params(rng, (3,), 1, 16, cuda_device), (3,), (1,))
    with pytest.raises(ValueError, match="contiguous on"):
        resblock_stage_int8(torch.zeros(1, 16, 16, device=cuda_device),
                            quantize_branch_params(_branch_params(rng, (3,), 1, 16, "cpu")), (3,), (1,))


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


def _packed_problem(rng, B, T, hiddens, device):
    gates, w_hh = [], []
    for H in hiddens:
        gates.append(torch.from_numpy(rng.standard_normal((B, T, 4 * H)).astype(np.float32)))
        bound = 1.0 / np.sqrt(H)
        w_hh.append(torch.from_numpy(rng.uniform(-bound, bound, (4 * H, H)).astype(np.float32)))
    hp = max(hiddens)
    dh = torch.zeros(len(hiddens), B, T, hp)
    for s, H in enumerate(hiddens):  # no gradient reaches a padded unit
        dh[s, ..., :H] = torch.from_numpy(rng.standard_normal((B, T, H)).astype(np.float32))
    return pack_gates(gates, hp).to(device), pack_w_hh(w_hh, hp).to(device), dh.to(device)


# (B, T, hiddens): the training shape of one layer (8 recurrences, Hp = 80
# with three of four necks padded from 64), a ragged small one with Hp > H
# and T not a multiple of the dW kernel's 32-term chunk, and B = 1.
LSTM_BWD_SHAPES = [
    (16, 256, (80, 80, 64, 64, 64, 64, 64, 64)),
    (3, 33, (8, 80)),
    (1, 50, (24,)),
]


@pytest.mark.parametrize("B,T,hiddens", LSTM_BWD_SHAPES)
def test_lstm_training_form_matches_plain(cuda_device, B, T, hiddens):
    g, w, _ = _packed_problem(np.random.default_rng(3), B, T, hiddens, cuda_device)
    before = (lstm_recurrence.launches, lstm_recurrence.training_launches)
    h, c, acts = lstm_recurrence(g, w, save=True)
    torch.cuda.synchronize()
    assert lstm_recurrence.launches - before[0] == 1
    assert lstm_recurrence.training_launches - before[1] == 1
    h_p, c_p, acts_p = lstm_recurrence_plain(g, w, save=True)
    # exact f32 on both sides, sums in another order over up to 256 steps;
    # c is unbounded, so relative to its scale
    for got, want in ((h, h_p), (c, c_p), (acts, acts_p)):
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 5e-5 * max(want.abs().max().item(), 1.0)
    # the serving form gives the same h bit for bit
    assert torch.equal(lstm_recurrence(g, w), h)


@pytest.mark.parametrize("B,T,hiddens", LSTM_BWD_SHAPES)
def test_lstm_backward_kernel_matches_plain(cuda_device, B, T, hiddens):
    g, w, dh = _packed_problem(np.random.default_rng(4), B, T, hiddens, cuda_device)
    h, c, acts = lstm_recurrence_plain(g, w, save=True)
    before = lstm_backward.launches
    dg, dw = lstm_backward(dh, acts, c, h, w)
    torch.cuda.synchronize()
    assert lstm_backward.launches - before == 1
    dg_p, dw_p = lstm_backward_plain(dh, acts, c, h, w)
    hp = max(hiddens)
    assert dg.shape == (len(hiddens), B, T, 4 * hp) and dw.shape == (len(hiddens), hp, 4 * hp)
    # exact f32 on both sides; dgates chains up to T steps, dW sums B*T
    # terms in another order
    assert (dg - dg_p).abs().max().item() <= 1e-4 * max(dg_p.abs().max().item(), 1.0)
    assert (dw - dw_p).abs().max().item() <= 1e-4 * max(dw_p.abs().max().item(), 1.0)
    for s, H in enumerate(hiddens):  # padded units get exactly 0
        assert torch.all(dg[s].reshape(B, T, 4, hp)[..., H:] == 0.0)
        assert torch.all(dw[s, H:] == 0.0)
        assert torch.all(dw[s].reshape(hp, 4, hp)[..., H:] == 0.0)
    # two runs agree bit for bit (no atomics)
    dg2, dw2 = lstm_backward(dh, acts, c, h, w)
    assert torch.equal(dg, dg2) and torch.equal(dw, dw2)


def test_lstm_function_matches_autograd_of_plain(cuda_device):
    """Kernels B and C as one autograd.Function against autograd through
    the plain recurrence, on the card."""
    g, w, dh = _packed_problem(np.random.default_rng(5), 2, 40, (16, 24), cuda_device)
    g1, w1 = g.clone().requires_grad_(), w.clone().requires_grad_()
    (LSTMRecurrence.apply(g1, w1) * dh).sum().backward()
    g2, w2 = g.clone().requires_grad_(), w.clone().requires_grad_()
    (lstm_recurrence_plain(g2, w2) * dh).sum().backward()
    assert (g1.grad - g2.grad).abs().max().item() <= 1e-4 * g2.grad.abs().max().item()
    assert (w1.grad - w2.grad).abs().max().item() <= 1e-4 * w2.grad.abs().max().item()


def test_lstm_function_finite_differences(cuda_device):
    """Central differences of sum(h * dh) in float32 at a tiny shape. f32
    leaves about three digits at a step of 1e-2 (rounding of the loss
    against truncation), so this holds the kernel to 2e-2 relative only;
    the tight check is the one against the plain version above."""
    g, w, dh = _packed_problem(np.random.default_rng(6), 1, 6, (4,), cuda_device)
    g1, w1 = g.clone().requires_grad_(), w.clone().requires_grad_()
    (LSTMRecurrence.apply(g1, w1) * dh).sum().backward()

    def loss(gg, ww):
        return (lstm_recurrence(gg, ww).double() * dh.double()).sum().item()

    eps = 1e-2
    for tensor, grad in ((g, g1.grad), (w, w1.grad)):
        flat = tensor.reshape(-1)
        for idx in range(0, flat.numel(), max(flat.numel() // 12, 1)):
            old = flat[idx].item()
            flat[idx] = old + eps
            up = loss(g, w)
            flat[idx] = old - eps
            down = loss(g, w)
            flat[idx] = old
            fd = (up - down) / (2 * eps)
            assert abs(fd - grad.reshape(-1)[idx].item()) <= 2e-2 * max(abs(fd), 1.0)


def test_lstm_backward_rejects_bad_input(cuda_device):
    g, w, dh = _packed_problem(np.random.default_rng(7), 1, 5, (8,), cuda_device)
    h, c, acts = lstm_recurrence(g, w, save=True)
    with pytest.raises(ValueError):
        lstm_backward(dh.double(), acts, c, h, w)
    with pytest.raises(ValueError):
        lstm_backward(dh, acts[..., :-1], c, h, w)
    with pytest.raises(ValueError):
        lstm_backward(dh.transpose(1, 2), acts, c, h, w)
