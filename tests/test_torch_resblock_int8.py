"""Kernel A's int8 form (``quantize=True``) in the port, as the CPU runs it
(``resblock_stage_int8_plain``), against its own exact form and against the
JAX package's int8 stage (``fused_resblock_stage(interpret=True,
quantize=True)``).

Floors, as tests/test_pallas_resblock.py holds the JAX int8 path: SNR of
int8 against exact > 30 dB for one stage (kernel sizes (3, 5), dilations
(1, 2), C = 8, T = 64) and > 25 dB for the whole default generator (f32,
seeded weights at flax's init scales, an 8-frame mel). Port int8 against
JAX int8 on the stage: T = 64 fits in one activation tile on both sides, so
both take the same scales and the same integer sums, and only the f32
rounding of the epilogue can differ -> 1e-5 of the output scale. (On longer
inputs the two quantise differently: the port scales each ``INT8_TILE``
rows, the TPU kernel each 512- to 4096-sample block.)
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from styler_tpu.ops.pallas_resblock import branch_params_from_variables, fused_resblock_stage
from styler_tpu.vocoder.hifigan import Generator as JGenerator
from styler_tpu.vocoder.hifigan import HiFiGANConfig as JConfig
from styler_tpu_torch.core.convert import load_flax_tree
from styler_tpu_torch.ops.resblock import (
    INT8_TILE,
    Int8Branch,
    _conv_int8_plain,
    _tile_scales,
    fused_resblock_stage as port_stage,
    quantize_branch_params,
    quantize_weights,
    resblock_stage_int8,
    resblock_stage_int8_plain,
    resblock_stage_plain,
)
from styler_tpu_torch.vocoder.hifigan import Generator
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)

KS, DILS, C, T = (3, 5), (1, 2), 8, 64


def _snr(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return 10 * np.log10((want ** 2).sum() / max(((got - want) ** 2).sum(), 1e-30))


def _params(seed, kernel_sizes=KS, dilations=DILS, channels=C):
    """tests/test_pallas_resblock.py:_make_params, from a seeded numpy rng."""
    rng = np.random.default_rng(seed)
    params = {}
    for j, rk in enumerate(kernel_sizes):
        blk = {}
        for c in range(len(dilations)):
            for group in ("convs1", "convs2"):
                blk[f"{group}_{c}"] = {
                    "kernel": (rng.standard_normal((rk, channels, channels)) * 0.05).astype(np.float32),
                    "bias": (rng.standard_normal(channels) * 0.01).astype(np.float32),
                }
        params[f"resblocks_0_{j}"] = blk
    return params


def _port_bp(params, n):
    return [tuple(torch.from_numpy(np.array(a)) for a in bp)
            for bp in branch_params_from_variables(params, 0, n)]


def _stage_golden():
    params = _params(0)
    x = np.random.default_rng(1).standard_normal((2, T, C)).astype(np.float32)
    bp = branch_params_from_variables(params, 0, len(KS))
    run = lambda q: np.asarray(fused_resblock_stage(  # noqa: E731
        jnp.asarray(x), bp, kernel_sizes=KS, dilations=DILS, interpret=True, quantize=q))
    return {"params": params, "x": x, "exact": run(False), "int8": run(True)}


def _hifigan_params(seed):
    """A default-topology HiFi-GAN params tree drawn with numpy: convs at
    flax's lecun-normal scale 1/sqrt(fan_in), transposed convs at N(0, 0.01)
    (flax's init of ``ConvTranspose1dTorch``), zero biases."""
    rng = np.random.default_rng(seed)
    cfg = JConfig()

    def conv(k, cin, cout, std=None):
        std = std or 1.0 / np.sqrt(k * cin)
        return {"kernel": (rng.standard_normal((k, cin, cout)) * std).astype(np.float32),
                "bias": np.zeros(cout, np.float32)}

    ch = cfg.upsample_initial_channel
    params = {"conv_pre": conv(7, cfg.num_mels, ch)}
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        params[f"ups_{i}"] = conv(k, ch, ch // 2, std=0.01)
        ch //= 2
        for j, rk in enumerate(cfg.resblock_kernel_sizes):
            params[f"resblocks_{i}_{j}"] = {
                f"{g}_{c}": conv(rk, ch, ch) for c in range(3) for g in ("convs1", "convs2")}
    params["conv_post"] = conv(7, ch, 1)
    return params


def _generator_golden():
    params = _hifigan_params(3)
    mel = np.random.default_rng(2).standard_normal((1, 8, 80)).astype(np.float32)
    exact = JGenerator(JConfig(), compute_dtype=jnp.float32).apply({"params": params}, jnp.asarray(mel))
    return {"params": params, "mel": mel, "exact": np.asarray(exact)}


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    return golden(tmp_path_factory, "resblock_int8_stage", _stage_golden)


@pytest.fixture(scope="module")
def gen(tmp_path_factory):
    return golden(tmp_path_factory, "resblock_int8_generator", _generator_golden)


@pytest.mark.parametrize("k,channels", [(3, 8), (11, 32), (7, 64)])
def test_weights_and_scales_follow_the_tpu_formula(k, channels):
    """pallas_resblock.py:276-279 recomputed in numpy: one scale per conv
    and output channel over every tap and input channel."""
    w = (np.random.default_rng(k).standard_normal((3, k, channels, channels)) * 0.05).astype(np.float32)
    w[1, :, :, 0] = 0  # an all-zero output channel takes the 1e-12 floor
    q, s = quantize_weights(torch.from_numpy(w))
    assert q.dtype == torch.int8 and tuple(q.shape) == (3, k, channels, channels)
    s_np = np.maximum(np.abs(w).max(axis=(1, 2)), np.float32(1e-12)) * np.float32(1.0 / 127.0)
    q_np = np.clip(np.round(w / s_np[:, None, None, :]), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(q.numpy(), q_np.transpose(0, 1, 3, 2))  # kernel layout
    np.testing.assert_array_max_ulp(s.numpy(), s_np.astype(np.float32), maxulp=1)
    assert s[1, 0].item() == pytest.approx(1e-12 / 127)


def test_stage_int8_tracks_its_exact_form(stage):
    x = torch.from_numpy(stage["x"])
    bp = _port_bp(stage["params"], len(KS))
    exact = resblock_stage_plain(x, bp, KS, DILS).numpy()
    quant = port_stage(x, bp, KS, DILS, quantize=True).numpy()
    assert quant.shape == exact.shape and np.isfinite(quant).all()
    assert _snr(quant, exact) > 30.0
    np.testing.assert_allclose(exact, stage["exact"], rtol=1e-5, atol=1e-5)


def test_jax_stage_int8_tracks_its_exact_form(stage):
    assert _snr(stage["int8"], stage["exact"]) > 30.0


def test_stage_int8_matches_jax_int8(stage):
    got = port_stage(torch.from_numpy(stage["x"]), _port_bp(stage["params"], len(KS)),
                     KS, DILS, quantize=True).numpy()
    err = np.abs(got - stage["int8"]).max()
    assert err <= 1e-5 * np.abs(stage["int8"]).max(), err


@pytest.fixture(scope="module")
def port_gens(gen):
    out = {}
    for q in (False, True):
        g = Generator(compute_dtype=torch.float32, quantize=q)
        load_flax_tree(g, gen["params"])
        with torch.no_grad():
            out[q] = g.eval()(torch.from_numpy(gen["mel"])).numpy()
    return out


def test_generator_int8_tracks_its_exact_form(gen, port_gens):
    np.testing.assert_allclose(port_gens[False], gen["exact"], rtol=1e-4, atol=1e-5)
    assert port_gens[True].shape == gen["exact"].shape == (1, 8 * 256)
    assert _snr(port_gens[True], port_gens[False]) > 25.0


def test_all_zero_tile_takes_the_scale_floor():
    """A tile whose activations are all 0 takes s_x = 1e-6 / 127: q = 0, the
    conv gives exactly its bias there, nothing is NaN."""
    rng = np.random.default_rng(5)
    bp = _port_bp(_params(5, channels=16), len(KS))
    x = torch.from_numpy(rng.standard_normal((1, 3 * INT8_TILE, 16)).astype(np.float32))
    x[:, INT8_TILE:2 * INT8_TILE] = 0  # the middle tile and its halo rows are 0
    x[:, INT8_TILE - 8:INT8_TILE] = 0
    x[:, 2 * INT8_TILE:2 * INT8_TILE + 8] = 0
    br = quantize_branch_params(bp)[0]
    s_x = _tile_scales(torch.nn.functional.leaky_relu(x, 0.1), 2, INT8_TILE)
    assert s_x[0, 1].item() == pytest.approx(1e-6 / 127) and s_x[0, 0] > 1e-3
    y = _conv_int8_plain(x, br.w1[1], br.s1[1], br.b1[1], 2, INT8_TILE)
    assert torch.isfinite(y).all()
    torch.testing.assert_close(y[0, INT8_TILE:2 * INT8_TILE],
                               br.b1[1].expand(INT8_TILE, 16), rtol=0, atol=0)
    out = resblock_stage_int8_plain(torch.zeros(2, 40, 16), quantize_branch_params(bp), KS, DILS)
    assert torch.isfinite(out).all()


def test_rows_outside_the_sequence_enter_as_zeros():
    """SAME padding: taps that fall outside [0, T) read 0, never the
    previous conv's bias. With x = 0 the first conv gives its bias b1 on
    every row of [0, T); the second conv then sees lrelu(b1) on [0, T) and 0
    outside, so its edge rows sum fewer taps than its interior rows."""
    k, d, Cn, Tn = 5, 1, 16, 37
    rng = np.random.default_rng(6)
    w1 = torch.from_numpy((rng.standard_normal((1, k, Cn, Cn)) * 0.05).astype(np.float32))
    w2 = torch.from_numpy((rng.standard_normal((1, k, Cn, Cn)) * 0.05).astype(np.float32))
    b1 = torch.from_numpy(rng.uniform(0.5, 1.0, (1, Cn)).astype(np.float32))
    b2 = torch.zeros(1, Cn)
    br = quantize_branch_params([(w1, b1, w2, b2)])[0]
    out = resblock_stage_int8_plain(torch.zeros(1, Tn, Cn), [br], (k,), (d,)).numpy()[0]
    # the second conv by hand: q(b1) with its own scale, integer taps in range
    s_x = np.float32(b1.numpy().max()) * np.float32(1 / 127)
    q = np.clip(np.round(b1.numpy()[0] * (np.float32(1) / s_x)), -127, 127)
    wq = br.w2[0].numpy().astype(np.int64)  # [k, Cout, Cin]
    for t in (0, 1, Tn // 2, Tn - 1):
        taps = [j for j in range(k) if 0 <= t + j - (k - 1) // 2 < Tn]
        acc = sum(wq[j] @ q.astype(np.int64) for j in taps)
        want = acc.astype(np.float32) * (s_x * br.s2[0].numpy())
        np.testing.assert_allclose(out[t], want, rtol=1e-6, atol=1e-7)
    assert not np.allclose(out[0], out[Tn // 2])  # the edge really differs


def test_cpu_wrapper_counts_no_launch(stage):
    before = (port_stage.launches, resblock_stage_int8.launches)
    port_stage(torch.zeros(1, 8, C), _port_bp(stage["params"], len(KS)), KS, DILS, quantize=True)
    assert (port_stage.launches, resblock_stage_int8.launches) == before


def test_quantize_flag_takes_prequantised_branches(stage):
    x = torch.from_numpy(stage["x"])
    bp = _port_bp(stage["params"], len(KS))
    q = quantize_branch_params(bp)
    assert all(isinstance(b, Int8Branch) for b in q)
    torch.testing.assert_close(port_stage(x, q, KS, DILS, quantize=True),
                               port_stage(x, bp, KS, DILS, quantize=True), rtol=0, atol=0)


def test_bf16_input_keeps_an_f32_carry_and_returns_bf16(stage):
    x = torch.from_numpy(stage["x"]).to(torch.bfloat16)
    q = quantize_branch_params(_port_bp(stage["params"], len(KS)))
    got = resblock_stage_int8_plain(x, q, KS, DILS)
    want = resblock_stage_int8_plain(x.float(), q, KS, DILS)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)
