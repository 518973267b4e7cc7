"""Resblock branches with dilations of their own: the port's generators
against the JAX flax generators, and the stage functions against a loop
over their branches.

The flax ``Generator`` and ``ISTFTNetGenerator`` give each branch its own
``resblock_dilation_sizes`` entry (``styler_tpu/vocoder/hifigan.py:141-145``,
``istft_net.py:171-176``); the port passes the whole tuple to the stage, and
the branches may differ in how many dilations they have.

Both generators at ``upsample_initial_channel=32`` on seeded weights (normals
of std 1/sqrt(fan_in), biases 0.02) copied into the port with
``load_flax_tree``, and a seeded 16-frame mel:

- f32 against flax f32: exact f32 on both sides with sums in another order,
  measured 5e-7 to 1.5e-6 of the output peak -> 1e-5 of the peak. Applying
  the first branch's dilations to every branch misses by far more (the
  iSTFTNet probe of this fault measured 0.43 of the peak).
- bf16 against flax bf16 by the log-mel MAE of the waveforms (natural log):
  flax rounds the residual carry to bf16 after every conv, the port keeps it
  in f32 (the TPU kernel's semantics), so the two differ by more than bf16
  rounding. Measured 0.005 (iSTFTNet) and 0.013 to 0.015 (HiFi-GAN), about
  what flax bf16 differs from flax f32 -> bound 0.05, as
  tests/test_torch_vocoder.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from styler_tpu.vocoder.hifigan import Generator as JHiFiGAN
from styler_tpu.vocoder.hifigan import HiFiGANConfig as JHiFiGANConfig
from styler_tpu.vocoder.istft_net import ISTFTNetConfig as JISTFTNetConfig
from styler_tpu.vocoder.istft_net import ISTFTNetGenerator as JISTFTNet
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.core.convert import load_flax_tree
from styler_tpu_torch.dsp.mel import MelFrontend
from styler_tpu_torch.ops.resblock import (
    branch_dilations,
    quantize_branch_params,
    resblock_stage_int8_plain,
    resblock_stage_plain,
    stage_launches,
)
from styler_tpu_torch.vocoder.hifigan import Generator, HiFiGANConfig
from styler_tpu_torch.vocoder.istft_net import ISTFTNetConfig, ISTFTNetGenerator
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)

DILATIONS = {"mixed": ((1, 3, 5), (1, 3, 5), (1, 2, 4)), "ragged": ((1, 3), (1, 3, 5), (2, 4, 6))}
ARCHS = {
    "istftnet": (JISTFTNet, JISTFTNetConfig, ISTFTNetGenerator, ISTFTNetConfig),
    "hifigan": (JHiFiGAN, JHiFiGANConfig, Generator, HiFiGANConfig),
}
FRAMES = 16


def _mel():
    return np.random.default_rng(1).standard_normal((1, FRAMES, 80)).astype(np.float32)


def _seeded(tree, rng):
    """The flax tree's shapes, filled with seeded normals."""
    out = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out[k] = _seeded(v, rng)
        elif k == "bias":
            out[k] = (rng.standard_normal(v.shape) * 0.02).astype(np.float32)
        else:
            out[k] = (rng.standard_normal(v.shape) / np.sqrt(np.prod(v.shape[:-1]))).astype(np.float32)
    return out


def _config(arch, dils):
    return dict(upsample_initial_channel=32, resblock_dilation_sizes=DILATIONS[dils])


def _jax_outputs(arch, dils):
    """Seeded params, and the flax generator's waveform in f32 and bf16."""
    jgen, jcfg, _, _ = ARCHS[arch]
    cfg = jcfg(**_config(arch, dils))
    mel = jnp.asarray(_mel())
    shapes = jax.eval_shape(lambda: jgen(cfg, compute_dtype=jnp.float32).init(jax.random.PRNGKey(0), mel))
    params = _seeded(shapes["params"], np.random.default_rng(0))
    out = {"params": params}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        apply = jax.jit(lambda p, m, dt=dt: jgen(cfg, compute_dtype=dt).apply({"params": p}, m))
        out[name] = np.asarray(apply(params, mel)).astype(np.float32)
    return out


def _port(arch, dils, params, dtype):
    _, _, pgen, pcfg = ARCHS[arch]
    g = pgen(pcfg(**_config(arch, dils)), compute_dtype=dtype)
    load_flax_tree(g, params)
    return g.eval()


@pytest.mark.parametrize("dils", sorted(DILATIONS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_generator_f32_matches_flax(tmp_path_factory, arch, dils):
    want = golden(tmp_path_factory, f"branch_dilations_{arch}_{dils}", lambda: _jax_outputs(arch, dils))
    with torch.no_grad():
        got = _port(arch, dils, want["params"], torch.float32)(torch.from_numpy(_mel())).numpy()
    assert got.shape == want["f32"].shape == (1, FRAMES * 256)
    peak = float(np.abs(want["f32"]).max())
    np.testing.assert_allclose(got, want["f32"], rtol=0, atol=1e-5 * peak)


@pytest.mark.parametrize("dils", sorted(DILATIONS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_generator_bf16_matches_flax_by_log_mel(tmp_path_factory, arch, dils):
    want = golden(tmp_path_factory, f"branch_dilations_{arch}_{dils}", lambda: _jax_outputs(arch, dils))
    with torch.no_grad():
        got = _port(arch, dils, want["params"], torch.bfloat16)(torch.from_numpy(_mel())).numpy()
    assert got.shape == want["bf16"].shape and np.isfinite(got).all()
    fe = MelFrontend(default_config())
    assert float(np.abs(fe(got[0])[0] - fe(want["bf16"][0])[0]).mean()) < 0.05


def test_hifigan_branches_hold_their_own_dilations():
    g = Generator(HiFiGANConfig(upsample_initial_channel=32, resblock_dilation_sizes=DILATIONS["ragged"]))
    for i in range(4):
        for j, ds in enumerate(DILATIONS["ragged"]):
            assert getattr(g, f"resblocks_{i}_{j}").w1.shape[0] == len(ds)


def _stage_problem(seed, kernel_sizes, dils, C=16, B=2, T=300):
    rng = np.random.default_rng(seed)
    bp = []
    for k, ds in zip(kernel_sizes, dils):
        w1, w2 = (torch.from_numpy((rng.standard_normal((len(ds), k, C, C)) * 0.1).astype(np.float32))
                  for _ in range(2))
        b1, b2 = (torch.from_numpy((rng.standard_normal((len(ds), C)) * 0.01).astype(np.float32))
                  for _ in range(2))
        bp.append((w1, b1, w2, b2))
    x = torch.from_numpy(rng.standard_normal((B, T, C)).astype(np.float32))
    return x, bp


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dils", sorted(DILATIONS))
def test_stage_plain_is_a_loop_over_branches(dils, int8):
    """Each branch with its own tuple, then the mean: the same sums in the
    same order as the single-branch calls, so equal bit for bit in f32.
    T = 300 spans three int8 scale windows."""
    ks, ds = (3, 7, 11), DILATIONS[dils]
    x, bp = _stage_problem(3, ks, ds)
    params = quantize_branch_params(bp) if int8 else bp
    stage = resblock_stage_int8_plain if int8 else resblock_stage_plain
    got = stage(x, params, ks, ds)
    total = None
    for p, k, d in zip(params, ks, ds):
        xb = stage(x, [p], (k,), d)
        total = xb if total is None else total + xb
    torch.testing.assert_close(got, total * (1.0 / len(ks)), rtol=0, atol=0)


def test_branch_dilations_and_launch_count():
    assert branch_dilations((1, 3, 5), 3) == [(1, 3, 5)] * 3
    assert branch_dilations(DILATIONS["ragged"], 3) == list(DILATIONS["ragged"])
    assert stage_launches((1, 3, 5), 3) == 18
    assert stage_launches(DILATIONS["ragged"], 3) == 16
    with pytest.raises(ValueError, match="2 dilation tuples for 3 branches"):
        branch_dilations(((1,), (2,)), 3)
