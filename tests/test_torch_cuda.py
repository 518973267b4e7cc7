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
    INSTANCES,
    LSTMRecurrence,
    force_lstm_plan,
    lstm_backward,
    lstm_launch_plan,
    lstm_plan,
    lstm_step_probe,
    lstm_backward_plain,
    lstm_recurrence,
    lstm_recurrence_plain,
    pack_gates,
    pack_w_hh,
)
from styler_tpu_torch.ops.resblock import (
    INT8_TILE,
    bf16_launch_plan,
    force_int8_tile,
    fused_resblock_stage,
    int8_launch_plan,
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
    """Seeded (w1, b1, w2, b2) per kernel size; ``n_dil`` is one count for
    every branch or one per branch."""
    out = []
    n_dils = n_dil if isinstance(n_dil, (tuple, list)) else [n_dil] * len(kernel_sizes)
    for k, nd in zip(kernel_sizes, n_dils):
        w1, w2 = (
            torch.from_numpy(
                (rng.standard_normal((nd, k, C, C)) * 0.05).astype(np.float32)
            ).to(device)
            for _ in range(2)
        )
        b1, b2 = (
            torch.from_numpy(
                (rng.standard_normal((nd, C)) * 0.01).astype(np.float32)
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
        # bf16 at every N tile (BN = 32, 64, 128) and ragged edge: C not a
        # multiple of 16 (8, 24, 136) or of BN (16, 24, 136), T of one row,
        # below the halo and not a multiple of BM, B in the grid
        (torch.bfloat16, 2, 64, 8, (3, 5), (1, 2), 3e-2),
        (torch.bfloat16, 1, 1, 16, (3, 7, 11), (1, 3, 5), 3e-2),
        (torch.bfloat16, 3, 40, 24, (3, 7, 11), (1, 3, 5), 3e-2),
        (torch.bfloat16, 1, 513, 32, (3, 7, 11), (1, 3, 5), 3e-2),
        (torch.bfloat16, 3, 1000, 64, (3, 7, 11), (1, 3, 5), 3e-2),
        (torch.bfloat16, 1, 513, 128, (3, 7, 11), (1, 3, 5), 3e-2),
        (torch.bfloat16, 3, 40, 136, (3, 7, 11), (1, 3, 5), 3e-2),
        (torch.bfloat16, 3, 513, 256, (3, 7, 11), (1, 3, 5), 3e-2),
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


@pytest.mark.parametrize("C", [32, 128])
def test_resblock_kernel_single_pair_matches_plain(cuda_device, C):
    """One conv pair, (k, dil) = (11, 5): the first conv writes
    bf16(lrelu(y)) and the second reads it as it is, so a wrongly
    activated or rounded intermediate shows up here on its own."""
    rng = np.random.default_rng(C + 11)
    bp = _branch_params(rng, (11,), 1, C, cuda_device)
    x = torch.from_numpy(rng.standard_normal((2, 777, C)).astype(np.float32))
    x = x.to(cuda_device, torch.bfloat16)
    before = fused_resblock_stage.launches
    got = fused_resblock_stage(x, bp, (11,), (5,))
    torch.cuda.synchronize()
    assert fused_resblock_stage.launches - before == 2
    want = resblock_stage_plain(x, bp, (11,), (5,))
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 3e-2 * max(scale, 1.0), (err, scale)


@pytest.mark.parametrize("B,T,C", [(2, 3000, 64), (1, 1025, 128), (2, 700, 32)])
def test_resblock_kernel_is_deterministic(cuda_device, B, T, C):
    """No atomics and no split over input channels: two calls agree bit
    for bit."""
    rng = np.random.default_rng(T)
    bp = _branch_params(rng, (3, 7, 11), 3, C, cuda_device)
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32))
    x = x.to(cuda_device, torch.bfloat16)
    a = fused_resblock_stage(x, bp)
    b = fused_resblock_stage(x, bp)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_resblock_plan_follows_c(cuda_device):
    """The N tile is the smallest of 32, 64, 128 that holds C (128 with
    more column blocks above), and at the main path's shapes every conv of
    a stage keeps 16 warps on an SM (2 CTAs of 256 threads, 4 of 128 or
    1 of 512)."""
    for C, bn in ((8, 32), (24, 32), (32, 32), (40, 64), (64, 64), (96, 128),
                  (128, 128), (136, 128), (256, 128)):
        plan = bf16_launch_plan(2, 4096, C, 11, 5)
        assert plan["tile"][1] == bn and plan["grid"][1] == -(-C // bn), (C, plan)
        assert plan["grid"][0] == -(-4096 // plan["tile"][0]) and plan["grid"][2] == 2
        assert plan["ctas_per_sm"] >= 1
    for B, T, C in ((2, 8192, 256), (2, 65536, 128), (2, 131072, 64), (2, 262144, 32)):
        for k in (3, 7, 11):
            for dil in (1, 3, 5):
                plan = bf16_launch_plan(B, T, C, k, dil)
                assert plan["ctas_per_sm"] * plan["threads"] >= 512, (B, T, C, k, dil, plan)


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


#: (BM, threads) of every int8 tile per N tile, as csrc/resblock_int8.cu's TILES
INT8_TILES = {32: ((256, 256), (128, 256)), 64: ((256, 256), (128, 256)),
              128: ((128, 256), (256, 512))}


def _int8_bn(C):
    return 32 if C <= 32 else 64 if C <= 64 else 128


@pytest.mark.parametrize("T", [1, 129, 255, 257, 513, 1000])
@pytest.mark.parametrize("C", [16, 32, 48, 64, 96, 128, 256])
def test_int8_kernel_matches_plain_on_every_tile(cuda_device, C, T):
    """Every tile of the N tile that C selects (where it fits; else the
    plan's own choice runs), at B = 1 (f32 output: bit for bit) and B = 3
    (bf16 output). T covers one row, a partial first and second
    scale window, a 256-row tile and one row more, and ragged ends."""
    ks, dils = (3, 7, 11), (1, 3, 5)
    bn = _int8_bn(C)
    for B, dtype in ((1, torch.float32), (3, torch.bfloat16)):
        rng = np.random.default_rng(7 * C + T + B)
        q = quantize_branch_params(_branch_params(rng, ks, len(dils), C, cuda_device))
        x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32)).to(cuda_device, dtype)
        want = resblock_stage_int8_plain(x, q, ks, dils)
        scale = want.float().abs().max().item()
        for bm, threads in INT8_TILES[bn]:
            force_int8_tile(bn, bm, threads)
            try:
                before = resblock_stage_int8.launches
                got = resblock_stage_int8(x, q, ks, dils)
                torch.cuda.synchronize()
            finally:
                force_int8_tile(bn)
            assert resblock_stage_int8.launches - before == 18
            assert got.dtype == dtype and got.shape == x.shape
            err = (got.float() - want.float()).abs().max().item()
            assert err <= INT8_TOL[dtype] * max(scale, 1.0), (B, bm, threads, err, scale)
            if dtype == torch.float32:
                assert torch.equal(got, want), (bm, threads, err)


def test_int8_kernel_scales_each_window(cuda_device):
    """Spikes of 1000 in otherwise unit-scale rows of x (f32, C = 64, so
    256-row tiles of two scale windows each): row 188 lies in the second
    window of the first tile and outside the first window's halo; row 126
    in the first window and inside the second window's halo; row 258 just
    past the tile's edge, inside the halo of the window before it. A
    kernel that took one scale per tile, or quantised the rows two windows
    share under only one of their scales, differs from the plain version;
    this one equals it bit for bit."""
    ks, dils, C, T = (3, 7, 11), (1, 3, 5), 64, 640
    rng = np.random.default_rng(11)
    q = quantize_branch_params(_branch_params(rng, ks, len(dils), C, cuda_device))
    xn = rng.standard_normal((1, T, C)).astype(np.float32)
    for t, c in ((188, 5), (126, 40), (258, 17)):
        xn[0, t, c] = 1000.0
    x = torch.from_numpy(xn).to(cuda_device)
    want = resblock_stage_int8_plain(x, q, ks, dils)
    # the test can tell: one scale per 256 rows changes the result
    assert not torch.equal(resblock_stage_int8_plain(x, q, ks, dils, tile=2 * INT8_TILE), want)
    force_int8_tile(64, 256, 256)
    try:
        assert int8_launch_plan(1, T, C, 11, 5)["tile"] == [256, 64]
        got = resblock_stage_int8(x, q, ks, dils)
        torch.cuda.synchronize()
    finally:
        force_int8_tile(64)
    assert torch.equal(got, want)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("C", [32, 128])
def test_kernels_take_dilations_per_branch(cuda_device, C, int8):
    """Branches of 2, 3 and 3 dilations of their own: two launches per
    dilation of each branch (16), each branch against the plain version."""
    ks, dils = (3, 7, 11), ((1, 3), (1, 3, 5), (2, 4, 6))
    rng = np.random.default_rng(C + int8)
    bp = _branch_params(rng, ks, [len(d) for d in dils], C, cuda_device)
    x = torch.from_numpy(rng.standard_normal((2, 777, C)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    fn = resblock_stage_int8 if int8 else fused_resblock_stage
    params = quantize_branch_params(bp) if int8 else bp
    plain = resblock_stage_int8_plain if int8 else resblock_stage_plain
    before = fn.launches
    got = fn(x, params, ks, dils)
    torch.cuda.synchronize()
    assert fn.launches - before == 16
    want = plain(x, params, ks, dils)
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    tol = INT8_TOL[torch.bfloat16] if int8 else 3e-2
    assert err <= tol * max(scale, 1.0), (err, scale)


def test_int8_plan_follows_c(cuda_device):
    """The N tile is the smallest of 32, 64, 128 that holds C (128 with
    more column blocks above); the tile holds whole scale windows; at the
    main path's shapes every conv keeps 16 warps on an SM and the
    weights stay resident at C = 32 and 64."""
    for C in (16, 32, 48, 64, 96, 128, 256):
        bn = _int8_bn(C)
        plan = int8_launch_plan(2, 4096, C, 11, 5)
        assert plan["tile"][1] == bn and plan["grid"][1] == -(-C // bn), (C, plan)
        assert plan["grid"][0] == -(-4096 // plan["tile"][0]) and plan["grid"][2] == 2
        assert plan["tile"][0] % INT8_TILE == 0
        assert plan["ctas_per_sm"] >= 1
    for B, T, C in ((2, 8192, 256), (2, 65536, 128), (2, 131072, 64), (2, 262144, 32)):
        for k in (3, 7, 11):
            for dil in (1, 3, 5):
                plan = int8_launch_plan(B, T, C, k, dil)
                assert plan["ctas_per_sm"] * plan["threads"] >= 512, (B, T, C, k, dil, plan)
                if C <= 64:
                    assert plan["weights"] == "resident", (C, k, dil, plan)


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


# Every plan class of kernels B and C (registers: Hp 8..96; shared
# memory: 104; weights read from w_t: 128, 256) at T from one step to
# more than 256 and B from 1 to 16. Two recurrences, the second 5 units
# narrower and padded, so padding runs at every width.
LSTM_PLAN_HPS = (8, 24, 64, 80, 96, 104, 128, 256)
LSTM_PLAN_TS = (1, 2, 33, 256, 300)
LSTM_PLAN_BS = (1, 3, 16)


def _plan_problem(hp, B, T, device, seed=8):
    hiddens = (hp, max(1, hp - 5))
    return (*_packed_problem(np.random.default_rng(seed), B, T, hiddens, device), hiddens)


def _check_forward(g, w, hiddens):
    """Both forms against the plain version at the card tolerances; h of
    the two forms bit-equal; padded units of h and c exactly 0."""
    h, c, acts = lstm_recurrence(g, w, save=True)
    h_s = lstm_recurrence(g, w)
    torch.cuda.synchronize()
    h_p, c_p, acts_p = lstm_recurrence_plain(g, w, save=True)
    assert (h_s - h_p).abs().max().item() < 2e-5
    for got, want in ((h, h_p), (c, c_p), (acts, acts_p)):
        assert (got - want).abs().max().item() <= 5e-5 * max(want.abs().max().item(), 1.0)
    assert torch.equal(h_s, h)
    for s, H in enumerate(hiddens):
        assert torch.all(h[s, ..., H:] == 0.0) and torch.all(c[s, ..., H:] == 0.0)


def _check_backward(g, w, dh, hiddens):
    """Kernel C against the plain version (1e-4 of the scale), padded
    units exactly 0, two runs bit-equal."""
    h, c, acts = lstm_recurrence_plain(g, w, save=True)
    dg, dw = lstm_backward(dh, acts, c, h, w)
    torch.cuda.synchronize()
    dg_p, dw_p = lstm_backward_plain(dh, acts, c, h, w)
    assert (dg - dg_p).abs().max().item() <= 1e-4 * max(dg_p.abs().max().item(), 1.0)
    assert (dw - dw_p).abs().max().item() <= 1e-4 * max(dw_p.abs().max().item(), 1.0)
    S, B, T, hp = dh.shape
    for s, H in enumerate(hiddens):
        assert torch.all(dg[s].reshape(B, T, 4, hp)[..., H:] == 0.0)
        assert torch.all(dw[s, H:] == 0.0) and torch.all(dw[s].reshape(hp, 4, hp)[..., H:] == 0.0)
    dg2, dw2 = lstm_backward(dh, acts, c, h, w)
    assert torch.equal(dg, dg2) and torch.equal(dw, dw2)


@pytest.mark.parametrize("B", LSTM_PLAN_BS)
@pytest.mark.parametrize("T", LSTM_PLAN_TS)
@pytest.mark.parametrize("hp", LSTM_PLAN_HPS)
def test_lstm_plan_forward_matches_plain(cuda_device, hp, T, B):
    g, w, _, hiddens = _plan_problem(hp, B, T, cuda_device)
    _check_forward(g, w, hiddens)


@pytest.mark.parametrize("B", LSTM_PLAN_BS)
@pytest.mark.parametrize("T", LSTM_PLAN_TS)
@pytest.mark.parametrize("hp", LSTM_PLAN_HPS)
def test_lstm_plan_backward_matches_plain(cuda_device, hp, T, B):
    g, w, dh, hiddens = _plan_problem(hp, B, T, cuda_device)
    _check_backward(g, w, dh, hiddens)


@pytest.mark.parametrize("instance,hp,B,T", [
    (inst, hp, B, T) for inst in INSTANCES
    for hp, B, T in ((8, 3, 33), (80, 16, 256), (97, 2, 40), (112, 1, 300))
    if inst != "registers" or hp <= 96
])
def test_lstm_every_instance_matches_plain(cuda_device, instance, hp, B, T):
    """Each instance forced at the widths it takes (the register one up to
    96), against the plain version."""
    g, w, dh, hiddens = _plan_problem(hp, B, T, cuda_device, seed=9)
    force_lstm_plan(instance=instance)
    try:
        assert lstm_plan(hp, 2, B)["backward"]["instance"] == instance
        _check_forward(g, w, hiddens)
        _check_backward(g, w, dh, hiddens)
    finally:
        force_lstm_plan()


def test_lstm_instance_that_does_not_fit_raises(cuda_device):
    g, w, dh, _ = _plan_problem(128, 1, 4, cuda_device)
    force_lstm_plan(instance="shared")
    try:
        with pytest.raises(ValueError, match="shared memory"):
            lstm_recurrence(g, w)
    finally:
        force_lstm_plan()


@pytest.mark.parametrize("B,splits", [(5, 2), (5, 3), (16, 6), (17, 4), (3, 3)])
def test_lstm_dw_split_matches_plain(cuda_device, B, splits):
    """dW's batch-row split at B that the split does not divide (set
    through the timing helper): the same dW as one split to the product's
    rounding, bit-equal across runs."""
    from styler_tpu_torch.ops.lstm import lstm_backward_part

    g, w, dh, hiddens = _plan_problem(80, B, 45, cuda_device, seed=10)
    assert lstm_plan(80, 2, B, dw_splits=splits)["backward"]["dw_splits"] == splits
    _check_backward(g, w, dh, hiddens)
    h, c, acts = lstm_recurrence_plain(g, w, save=True)
    dg, _ = lstm_backward(dh, acts, c, h, w)
    dw_split, dw_again, dw_one = (torch.full_like(w, float("nan")) for _ in range(3))
    for out, n in ((dw_split, splits), (dw_again, splits), (dw_one, 1)):
        lstm_backward_part("dw", dh, acts, c, h, w, dg, out, dw_splits=n)
    torch.cuda.synchronize()
    assert torch.equal(dw_split, dw_again)
    assert (dw_split - dw_one).abs().max().item() <= 1e-5 * dw_one.abs().max().item()


def test_lstm_dw_split_of_the_plan_at_uneven_batch(cuda_device):
    """The plan's own split where it does not divide B: 8 recurrences at
    Hp = 80 and B = 19 split into 10 groups of 2 rows, the last of 1."""
    hiddens = (80, 80, 75, 75, 64, 64, 64, 64)
    g, w, dh = _packed_problem(np.random.default_rng(12), 19, 45, hiddens, cuda_device)
    bwd = lstm_plan(80, 8, 19)["backward"]
    assert (bwd["dw_splits"], bwd["dw_rows_per_split"]) == (10, 2)
    _check_backward(g, w, dh, hiddens)


@pytest.mark.parametrize("hp", [1, 8, 9, 80, 96, 97, 104, 112, 113, 120, 121, 128, 255, 256])
def test_lstm_launch_plan_at_boundary_widths(cuda_device, hp):
    """The kernels' own threads agree with the plan (lstm_launch_plan
    raises otherwise), their shared memory fits one block, and they
    report registers."""
    plan = lstm_launch_plan(hp, 8, 16)
    assert plan == {**lstm_plan(hp, 8, 16), "recurrence": plan["recurrence"],
                    "backward": plan["backward"]}
    rec, bwd = plan["recurrence"], plan["backward"]
    for smem in (rec["smem_bytes"], bwd["smem_bytes"], bwd["dw_smem_bytes"]):
        assert 0 < smem <= 232448  # what one block may use on sm_90
    if hp == 80:  # h[2][4 slices of 20], dg[2][16 slices of 20], a 4-chunk ring of 32 steps
        assert (rec["smem_bytes"], bwd["smem_bytes"]) == (2 * 4 * 20 * 4, 2 * 16 * 20 * 4)
        assert bwd["dw_smem_bytes"] == 4 * 32 * (80 + 64) * 4
    for regs in (rec["registers_serving"], rec["registers_training"], bwd["registers"],
                 bwd["dw_registers"]):
        assert 0 < regs <= 255
    if rec["instance"] == "registers":  # W weights of the thread stay in registers
        assert rec["registers_serving"] >= plan["width"]


def test_lstm_backward_parts_match_the_whole(cuda_device):
    """The walk alone and the dW product alone (timing only) give what one
    lstm_backward call gives, bit for bit, and count no launch."""
    from styler_tpu_torch.ops.lstm import lstm_backward_part

    g, w, dh, _ = _plan_problem(80, 3, 40, cuda_device, seed=11)
    h, c, acts = lstm_recurrence_plain(g, w, save=True)
    dg, dw = lstm_backward(dh, acts, c, h, w)
    before = lstm_backward.launches
    dg2, dw2 = torch.full_like(dg, float("nan")), torch.full_like(dw, float("nan"))
    lstm_backward_part("walk", dh, acts, c, h, w, dg2, dw2)
    lstm_backward_part("dw", dh, acts, c, h, w, dg2, dw2)
    torch.cuda.synchronize()
    assert torch.equal(dg, dg2) and torch.equal(dw, dw2)
    assert lstm_backward.launches == before


def test_lstm_step_probe_runs(cuda_device):
    out = lstm_step_probe(16, 320, cuda_device)
    torch.cuda.synchronize()
    assert out.shape == (8,) and torch.all(out == 0.0)


# Batched serving: synthesize_batch at 16 rows runs the vocoder on 32
# (clean and noisy), mix_and_match on 32. Kernel A takes the batch as grid
# rows (gridDim.z), so 32 rows at the HiFi-GAN last stage is 2.7e8
# elements a tensor: offsets formed in 64 bits, not in int.
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("T,C", [(8192, 256), (262144, 32)])
def test_resblock_kernels_at_32_rows(cuda_device, T, C, int8):
    B = 32
    rng = np.random.default_rng(T + C)
    ks, dils = (3, 7, 11), (1, 3, 5)
    bp = _branch_params(rng, ks, len(dils), C, cuda_device)
    x = torch.randn(B, T, C, generator=torch.Generator().manual_seed(C)).to(cuda_device, torch.bfloat16)
    if int8:
        q = quantize_branch_params(bp)
        fn, plain, params, tol = resblock_stage_int8, resblock_stage_int8_plain, q, INT8_TOL[torch.bfloat16]
    else:
        bp16 = [tuple(t.to(torch.bfloat16) if t.dim() == 4 else t for t in b) for b in bp]
        fn, plain, params, tol = fused_resblock_stage, resblock_stage_plain, bp16, 3e-2
    plan = (int8_launch_plan if int8 else bf16_launch_plan)(B, T, C, 11, 5)
    assert plan["grid"][2] == B
    before = fn.launches
    with torch.no_grad():
        got = fn(x, params, ks, dils)
        torch.cuda.synchronize()
        assert fn.launches - before == 18
        want = plain(x, params, ks, dils)
    assert got.shape == x.shape and torch.isfinite(got).all()
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(scale, 1.0), (err, scale)
    # the last row is its own request: alone, it gives the same result
    # (no row reads another row's data)
    with torch.no_grad():
        alone = fn(x[-1:].contiguous(), params, ks, dils)
    err_row = (alone[0].float() - got[-1].float()).abs().max().item()
    assert err_row <= tol * max(scale, 1.0), (err_row, scale)
    del got, want, alone
    torch.cuda.empty_cache()


def _bilstm_problem(rng, B, T, hiddens, in_dims, device):
    """Seeded two-layer BiLSTM params per branch (the audio encoder's
    layout), inputs zero past ragged valid lengths, and the lengths."""
    params = []
    for H, n_in in zip(hiddens, in_dims):
        layers = []
        for layer in range(2):
            fan_in = n_in if layer == 0 else 2 * H
            bound = 1.0 / np.sqrt(H)
            layers.append({d: {n: torch.from_numpy(rng.uniform(-bound, bound, s).astype(np.float32)).to(device)
                               for n, s in (("w_ih", (4 * H, fan_in)), ("w_hh", (4 * H, H)),
                                            ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))}
                           for d in ("fwd", "bwd")})
        params.append(layers)
    lengths = np.sort(rng.integers(1, T + 1, B))[::-1].copy()
    lengths[0] = T
    lengths[-1] = 1  # a one-phoneme row
    valid = (np.arange(T)[None, :] < lengths[:, None])[..., None]
    xs = [torch.from_numpy((np.maximum(rng.standard_normal((B, T, n)), 0) * valid).astype(np.float32)).to(device)
          for n in in_dims]
    return params, xs, torch.from_numpy(lengths).to(device)


@pytest.mark.parametrize("B", [4, 16])
@pytest.mark.parametrize("T", [32, 256])
def test_lstm_serving_form_ragged_batch(cuda_device, B, T):
    """Kernel B's serving form inside the audio encoder's BiLSTM (masking
    and flips outside the kernel, ``ops/recurrent.py``) at the batch sizes
    of synthesize_batch (16), mix's base encode (4), rows of different
    valid lengths: against the same function on the CPU (the plain
    version). Exact f32 on both sides (TF32 off), sums in another order."""
    from styler_tpu_torch.ops.recurrent import fused_bilstm_branches

    rng = np.random.default_rng(B * T)
    hiddens, in_dims = (80, 64, 64, 64), (256, 256, 256, 384)
    params, xs, lengths = _bilstm_problem(rng, B, T, hiddens, in_dims, cuda_device)
    before = (lstm_recurrence.launches, lstm_recurrence.training_launches)
    with torch.no_grad():
        got = fused_bilstm_branches(params, xs, lengths)
        torch.cuda.synchronize()
    assert lstm_recurrence.launches - before[0] == 2  # one per layer
    assert lstm_recurrence.training_launches == before[1]
    cpu = lambda t: t.cpu()  # noqa: E731
    with torch.no_grad():
        want = fused_bilstm_branches([[{d: {n: cpu(v) for n, v in p.items()} for d, p in layer.items()}
                                       for layer in br] for br in params],
                                     [cpu(x) for x in xs], cpu(lengths))
    for g, w, H in zip(got, want, hiddens):
        assert g.shape == (B, T, 2 * H)
        assert (g.cpu() - w).abs().max().item() < 1e-4
        for b, n in enumerate(lengths.tolist()):
            assert torch.all(g[b, n:, H:] == 0)  # the backward half's padding stays 0


# ---------------------------------------------------------------------------
# The speaker encoders: cuDNN f32 convolutions (TF32 off), no kernel of the
# port's own; the card against the CPU.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,W", [(20, 64), (21, 33), (160, 64)])
def test_speaker_stage_card_vs_cpu(cuda_device, T, W):
    """One stride-2 stage with its asymmetric 'SAME' padding (even sizes pad
    (1, 2)) on the card against the CPU; f32 sums in another order."""
    from styler_tpu_torch.speaker.rescnn import ConvResStage

    torch.manual_seed(T * W)
    stage = ConvResStage(1, 16, 3).eval()
    x = torch.randn(2, 1, T, W)
    with torch.no_grad():
        want = stage(x)
        got = stage.to(cuda_device)(x.to(cuda_device)).cpu()
    assert got.shape == want.shape == (2, 16, -(-T // 2), -(-W // 2))
    assert (got - want).abs().max().item() <= 1e-5 * max(1.0, want.abs().max().item())


@pytest.fixture(scope="module")
def speaker_embedders(cuda_device):
    from styler_tpu_torch.core.config import default_config
    from styler_tpu_torch.data.vctk import SpeakerEmbedder

    return (SpeakerEmbedder(default_config(), backend="native"),
            SpeakerEmbedder(default_config(), backend="native", device="cpu"))


@pytest.mark.parametrize("i", range(4))
def test_speaker_encoder_card_vs_cpu(speaker_embedders, i):
    """The trained encoder on each validation wav: unit norm, and the card's
    embedding within 1e-6 per entry of the CPU's (the f32 forward differs
    by ~5e-8 on the H100; one with TF32 allowed differs by more than 1e-6,
    chip_smoke.py's speaker phase)."""
    from styler_tpu_torch.data.audio_io import read_wav

    card, cpu = speaker_embedders
    assert next(card.model.parameters()).is_cuda
    audio = read_wav(f"assets/vocoder/val/val_000{i}.wav")[0]
    got, want = card.embed_wav(audio), cpu.embed_wav(audio)
    assert got.shape == want.shape == (1, 512) and np.isfinite(got).all()
    assert abs(float(np.linalg.norm(got)) - 1.0) < 1e-4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The serving bundle (core/export.py): one CUDA graph per entry, on the
# committed trained assets at full width and small buckets
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_bundle(cuda_device, tmp_path_factory):
    from styler_tpu_torch.core.config import default_config
    from styler_tpu_torch.core.export import ServingBundle, save_serving_bundle
    from styler_tpu_torch.synthesis import load_synthesizer

    cfg = default_config().replace(src_buckets=(32, 64), mel_buckets=(64,))
    out = str(tmp_path_factory.mktemp("cuda_bundle"))
    save_serving_bundle(load_synthesizer(cfg), out, batch=(1, 2))
    return ServingBundle(out)


def _bundle_arrays(key, seed, n_ids, n_frames, controls=(1.0, 1.0, 1.0)):
    """Seeded inputs of an entry (B, L, M): ``n_ids`` phonemes and
    ``n_frames`` reference frames in every row, zero padding after."""
    B, L, M = key
    rng = np.random.default_rng(seed)
    src = np.zeros((B, L), np.int64)
    src[:, :n_ids] = rng.integers(1, 70, (B, n_ids))
    mel = np.zeros((B, M, 80), np.float32)
    mel[:, :n_frames] = rng.standard_normal((B, n_frames, 80)) - 4.0
    f0 = np.zeros((B, M), np.float32)
    f0[:, :n_frames] = rng.random((B, n_frames))
    en = np.zeros((B, M), np.float32)
    en[:, :n_frames] = rng.random((B, n_frames))
    spk = rng.standard_normal((B, 512)).astype(np.float32) / 22.6
    return (src, np.full(B, n_ids), mel, f0, en, np.full(B, n_frames), spk, *controls)


def _eager(bundle, arrays):
    """The same inputs through the eager ``Synthesizer._forward`` (float
    controls, as the live path passes them)."""
    from styler_tpu_torch.core.export import _outputs

    dev = bundle.device
    t = [torch.from_numpy(np.asarray(a)).to(dev) for a in arrays[:7]]
    t[0], t[1], t[5] = (x.long() for x in (t[0], t[1], t[5]))
    out = bundle.synth._forward(*t, *(float(c) for c in arrays[7:]), bundle.mel_out)
    return {k: v.cpu().numpy() for k, v in _outputs(*out).items()}


def _assert_same(got, want):
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_bundle_replay_equals_eager(cuda_bundle):
    """A replay gives the eager forward's bits; the kernels' launch counts
    rise at capture (A 36, B 2 per iSTFTNet forward), not at replay."""
    key = (1, 32, 64)
    arrays = _bundle_arrays(key, 0, 20, 50)
    fused_resblock_stage.launches = lstm_recurrence.launches = 0
    got = cuda_bundle.call(*key, *arrays)  # capture (after one eager forward), replay
    assert (fused_resblock_stage.launches, lstm_recurrence.launches) == (72, 4)
    _assert_same(got, _eager(cuda_bundle, arrays))
    fused_resblock_stage.launches = lstm_recurrence.launches = 0
    again = cuda_bundle.call(*key, *arrays)
    assert (fused_resblock_stage.launches, lstm_recurrence.launches) == (0, 0)
    _assert_same(again, got)


def test_bundle_controls_are_read_at_replay(cuda_bundle):
    """Captured at controls 1.0, replayed at d 1.3 and p 0.8 (and e 1.1):
    eager at those values, and not the result at 1.0."""
    key = (1, 32, 64)
    cuda_bundle.call(*key, *_bundle_arrays(key, 1, 20, 50))
    arrays = _bundle_arrays(key, 1, 20, 50, controls=(1.3, 0.8, 1.1))
    got = cuda_bundle.call(*key, *arrays)
    _assert_same(got, _eager(cuda_bundle, arrays))
    at_one = _eager(cuda_bundle, _bundle_arrays(key, 1, 20, 50))
    assert not np.array_equal(got["f0"], at_one["f0"])


def test_bundle_alternating_entries(cuda_bundle):
    """Entries replayed A, B, A in the shared pool: eager's result each time."""
    a, b = (1, 32, 64), (2, 64, 64)
    xa, xb = _bundle_arrays(a, 2, 25, 40), _bundle_arrays(b, 3, 50, 60)
    for key, arrays in ((a, xa), (b, xb), (a, xa)):
        _assert_same(cuda_bundle.call(*key, *arrays), _eager(cuda_bundle, arrays))


def test_bundle_short_after_long_in_one_bucket(cuda_bundle):
    """A short request after a long one in the same entry equals a fresh
    eager short request: every input element, the padding included, is
    written at each call."""
    key = (1, 64, 64)
    cuda_bundle.call(*key, *_bundle_arrays(key, 4, 60, 64))
    short = _bundle_arrays(key, 5, 35, 20)
    _assert_same(cuda_bundle.call(*key, *short), _eager(cuda_bundle, short))


def test_bundle_synthesize_equals_live(cuda_bundle):
    """``ServingBundle.synthesize`` on the card equals the live
    ``Synthesizer.synthesize`` on the same synthesizer, bit for bit."""
    from styler_tpu_torch.synthesis import extract_reference_features

    synth = cuda_bundle.synth
    rng = np.random.default_rng(6)
    ref = extract_reference_features((rng.standard_normal(256 * 50) * 3000).astype(np.float32),
                                     synth.config, synth.frontend)
    spk = (rng.standard_normal(512) / 22.6).astype(np.float32)
    live = synth.synthesize("Hello there.", ref, spk, d_control=1.2)
    got = cuda_bundle.synthesize(synth.text_to_ids("Hello there."), ref.mel[: ref.mel_len],
                                 ref.f0_norm[: ref.mel_len], ref.energy01[: ref.mel_len], spk,
                                 d_control=1.2)
    assert got["mel_len"] == live["mel_len"] and not got["truncated"]
    for k in ("mel", "mel_noisy", "wav", "wav_noisy", "f0", "energy"):
        np.testing.assert_array_equal(got[k], live[k], err_msg=k)


def test_bundle_failed_capture_raises(cuda_bundle):
    """A forward that reads the card back cannot be captured: the call
    raises, with no eager fallback, and no graph is kept for the entry."""
    from styler_tpu_torch.core.export import ServingBundle

    bundle = ServingBundle(cuda_bundle.dir)
    forward = bundle.synth._forward

    def syncing(*a, **kw):
        out = forward(*a, **kw)
        float(out[1].sum())  # a host read: refused inside a capture
        return out

    bundle.synth._forward = syncing
    key = (2, 32, 64)
    with pytest.raises(RuntimeError):
        bundle.call(*key, *_bundle_arrays(key, 7, 10, 30))
    assert key not in bundle._graphs
    torch.cuda.synchronize()
