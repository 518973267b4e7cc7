"""The port's HiFi-GAN generator, vocoder factory and reference-checkpoint
importer against the JAX package.

- f32, full default topology (512 initial channels, upsampling 8, 8, 2, 2),
  the trained ``assets/vocoder/hifigan_gen.npz``, the first 8 frames of
  ``assets/vocoder/val_mel.npy``: against flax ``Generator.apply`` in f32,
  exact f32 on both sides with sums in another order -> rtol 1e-4, atol
  1e-5 (tests/test_pallas_resblock.py:115).
- bf16: against ``generator_apply_fused(..., interpret=True)`` in bf16, the
  Pallas path the JAX package serves with. Both keep the resblock carry in
  f32, but XLA and PyTorch round the bf16 convs (conv_pre, the upsamplers,
  conv_post) in other places, and four stages compound it: held to an SNR
  above 20 dB (measured 28.7 dB) and a max error of 0.05 on a 0.38 peak
  (measured 0.018).
- import: a seeded weight-norm reference generator (the reference's
  hifigan/models.py, as tests/test_vocoder_speaker.py rebuilds it) at a
  small config: the port's importer gives the leaves of the JAX
  ``import_hifigan_state`` bit for bit, and the port's generator on them
  the torch module's waveform within rtol 1e-3, atol 2e-4 (the JAX test's
  tolerance).
"""

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax.numpy as jnp

from styler_tpu.core.checkpoint import load_vocoder_npz as j_load
from styler_tpu.core.import_torch import import_hifigan_state as j_import
from styler_tpu.vocoder.hifigan import Generator as JGenerator
from styler_tpu.vocoder.hifigan import HiFiGANConfig as JConfig
from styler_tpu.vocoder.hifigan import generator_apply_fused
from styler_tpu_torch.core.checkpoint import flatten_tree, load_vocoder_npz
from styler_tpu_torch.core.convert import load_flax_tree
from styler_tpu_torch.core.import_torch import import_hifigan_state, load_reference_vocoder
from styler_tpu_torch.vocoder import ISTFTNetGenerator, make_generator, vocode
from styler_tpu_torch.vocoder.hifigan import Generator, HiFiGANConfig
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)

ASSET = "assets/vocoder/hifigan_gen.npz"
SMALL = dict(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
             resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 2), (1, 2)), num_mels=10)


def _mel():
    return np.load("assets/vocoder/val_mel.npy")[None, :8].astype(np.float32)


def _jax_f32():
    gen = JGenerator(compute_dtype=jnp.float32)
    return np.asarray(gen.apply({"params": j_load(ASSET)}, jnp.asarray(_mel())))


def _jax_fused_bf16():
    out = generator_apply_fused({"params": j_load(ASSET)}, jnp.asarray(_mel()),
                                compute_dtype=jnp.bfloat16, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(dtype, config=HiFiGANConfig(), params=None):
    g = Generator(config, compute_dtype=dtype)
    load_flax_tree(g, params if params is not None else load_vocoder_npz(ASSET))
    return g.eval()


def test_hifigan_f32_matches_flax_at_full_width(tmp_path_factory):
    want = golden(tmp_path_factory, "hifigan_f32", _jax_f32)
    got = vocode(_port(torch.float32), torch.from_numpy(_mel())).numpy()
    assert got.shape == want.shape == (1, 8 * 256)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_hifigan_bf16_matches_fused_pallas(tmp_path_factory):
    want = golden(tmp_path_factory, "hifigan_fused_bf16", _jax_fused_bf16)
    g = _port(torch.bfloat16)
    assert g.conv_post.weight.dtype == torch.float32  # stored f32, computed bf16
    got = vocode(g, torch.from_numpy(_mel())).numpy()
    assert got.shape == want.shape and got.dtype == np.float32 and np.isfinite(got).all()
    snr = 10 * np.log10((want.astype(np.float64) ** 2).sum() / ((got - want) ** 2).sum())
    assert snr > 20.0, snr
    assert np.abs(got - want).max() < 0.05


class _TorchResBlock(tnn.Module):
    """Reference hifigan ResBlock1 (models.py:28-75) with weight norm."""

    def __init__(self, ch, k, dilations):
        super().__init__()
        wn = tnn.utils.weight_norm
        self.convs1 = tnn.ModuleList(
            [wn(tnn.Conv1d(ch, ch, k, 1, dilation=d, padding=(k - 1) * d // 2)) for d in dilations])
        self.convs2 = tnn.ModuleList(
            [wn(tnn.Conv1d(ch, ch, k, 1, padding=(k - 1) // 2)) for _ in dilations])

    def forward(self, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            x = c2(tnn.functional.leaky_relu(c1(tnn.functional.leaky_relu(x, 0.1)), 0.1)) + x
        return x


class _TorchGenerator(tnn.Module):
    """Reference Generator (models.py:112-165) with weight norm, for the
    importer (the attribute names are the reference's state-dict keys)."""

    def __init__(self, cfg):
        super().__init__()
        wn = tnn.utils.weight_norm
        self.num_kernels = len(cfg.resblock_kernel_sizes)
        self.conv_pre = wn(tnn.Conv1d(cfg.num_mels, cfg.upsample_initial_channel, 7, 1, padding=3))
        self.ups = tnn.ModuleList()
        self.resblocks = tnn.ModuleList()
        for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
            ch_in = cfg.upsample_initial_channel // (2 ** i)
            ch = ch_in // 2
            self.ups.append(wn(tnn.ConvTranspose1d(ch_in, ch, k, u, padding=(k - u) // 2)))
            for rk, rd in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
                self.resblocks.append(_TorchResBlock(ch, rk, rd))
        self.conv_post = wn(tnn.Conv1d(ch, 1, 7, 1, padding=3))

    def forward(self, x):
        x = self.conv_pre(x)
        for i, up in enumerate(self.ups):
            x = up(tnn.functional.leaky_relu(x, 0.1))
            blocks = self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]
            x = sum(b(x) for b in blocks) / self.num_kernels
        return torch.tanh(self.conv_post(tnn.functional.leaky_relu(x)))


def reference_hifigan(cfg, seed):
    """A seeded weight-norm reference generator (biases drawn too, so the
    importer's bias path is exercised)."""
    torch.manual_seed(seed)
    tg = _TorchGenerator(cfg).eval()
    with torch.no_grad():
        for name, p in tg.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape) * 0.05)
    return tg


def test_importer_matches_jax_and_reference_waveform():
    cfg = HiFiGANConfig(**SMALL)
    tg = reference_hifigan(cfg, 0)
    sd = {f"module.{k}": v for k, v in tg.state_dict().items()}  # a DataParallel save
    assert any(k.endswith("weight_g") for k in sd)
    got = flatten_tree(import_hifigan_state(sd, cfg))
    want = flatten_tree(j_import(sd, JConfig(**SMALL)))
    assert set(got) == set(want) and len(got) == 4 + 2 * 2 * 2 * 2 * 2 + 2 * 2
    for k, v in want.items():
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    mel = np.random.default_rng(0).standard_normal((1, cfg.num_mels, 20)).astype(np.float32)
    with torch.no_grad():
        ref = tg(torch.from_numpy(mel)).numpy()[:, 0, :]
    out = vocode(_port(torch.float32, cfg, import_hifigan_state(sd, cfg)),
                 torch.from_numpy(mel.transpose(0, 2, 1))).numpy()
    assert out.shape == ref.shape == (1, 20 * 16)
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=2e-4)


def test_reference_checkpoint_file_loads(tmp_path):
    cfg = HiFiGANConfig()
    tg = reference_hifigan(cfg, 1)
    path = str(tmp_path / "generator_universal.pth.tar")
    torch.save({"generator": tg.state_dict()}, path)
    params = load_reference_vocoder(path, "HiFi-GAN")
    g = _port(torch.float32, cfg, params)  # every leaf used exactly once
    mel = np.random.default_rng(1).standard_normal((1, 80, 4)).astype(np.float32)
    with torch.no_grad():
        ref = tg(torch.from_numpy(mel)).numpy()[:, 0, :]
    out = vocode(g, torch.from_numpy(mel.transpose(0, 2, 1))).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("name", ["MelGAN", "WaveGlow"])
def test_later_vocoders_raise(name, tmp_path):
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        make_generator(name)
    with pytest.raises(NotImplementedError, match="Queue 1 item 15"):
        load_reference_vocoder(str(tmp_path / "x.pt"), name)


def test_factory_builds_both_and_names_the_choices():
    assert isinstance(make_generator("HiFi-GAN"), Generator)
    g = make_generator("iSTFTNet", quantize=True)  # the flag is HiFi-GAN's only
    assert isinstance(g, ISTFTNetGenerator) and g.compute_dtype == torch.bfloat16
    assert make_generator("HiFi-GAN", torch.float32, quantize=True).quantize
    with pytest.raises(ValueError, match=r"supported: \('HiFi-GAN', 'MelGAN', 'WaveGlow', 'iSTFTNet'\)"):
        make_generator("WaveNet")


def test_branches_with_other_dilations_are_refused():
    with pytest.raises(ValueError, match="every branch"):
        Generator(HiFiGANConfig(resblock_dilation_sizes=((1, 3, 5), (1, 3, 5), (1, 2, 4))))


def test_int8_weights_are_quantised_once_per_generator():
    g = _port(torch.float32, HiFiGANConfig(**SMALL), import_hifigan_state(
        reference_hifigan(HiFiGANConfig(**SMALL), 2).state_dict(), HiFiGANConfig(**SMALL)))
    g.quantize = True
    mel = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 6, 10)).astype(np.float32))
    first = vocode(g, mel)
    cached = g.int8_params(mel.device)
    assert g.int8_params(mel.device) is cached and cached[0][0].w1.dtype == torch.int8
    torch.testing.assert_close(vocode(g, mel), first, rtol=0, atol=0)
