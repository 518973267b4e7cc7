"""The port's speaker embedders against the JAX package (``styler_tpu/speaker``,
``styler_tpu/data/vctk.py:SpeakerEmbedder``) on the CPU.

Tolerances:
- fbank features, normalisation, the silence trim and the 160-frame crop:
  the same float64 numpy code on both sides -> bit-equal.
- one stride-2 stage (conv 5x5 'SAME', BN eps 1e-3, clipped ReLU, 3
  identity blocks) at 16 filters, on an even size (pads 1, 2) and an odd
  one (2, 2): f32 convolutions in another order -> 1e-5.
- the trained ``SpeakerEncoder`` (``assets/speaker/encoder_gen.npz``) on the
  same features: unit-norm outputs of ~0.1 per entry -> 2e-5 per entry.
- ``ResCNN`` at full width (24 M parameters, 2048 -> 512 affine) through
  ``import_deepspeaker_h5`` on an ``.h5`` the test writes: 1e-4, as the JAX
  package holds its own model to a torch rebuild
  (``tests/test_vocoder_speaker.py:336-387``).
- the spectral-envelope fallback: float64 numpy on both sides -> bit-equal.

The JAX outputs are computed once per session (``golden``).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from styler_tpu.core.checkpoint import load_acoustic_npz as j_load_npz
from styler_tpu.core.config import default_config as j_config
from styler_tpu.data.vctk import SpeakerEmbedder as JSpeakerEmbedder
from styler_tpu.speaker import ResCNN as JResCNN
from styler_tpu.speaker import SpeakerEncoder as JSpeakerEncoder
from styler_tpu.speaker import features as jfeat
from styler_tpu.speaker.rescnn import ConvResStage as JConvResStage
from styler_tpu.speaker.rescnn import import_deepspeaker_h5 as j_import_h5
from styler_tpu_torch.core.checkpoint import flatten_tree, load_acoustic_npz
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.core.convert import load_flax_tree, to_flax_tree
from styler_tpu_torch.data import vctk
from styler_tpu_torch.data.audio_io import read_wav
from styler_tpu_torch.data.vctk import SpeakerEmbedder
from styler_tpu_torch.speaker import (
    NUM_FRAMES,
    ResCNN,
    SpeakerEncoder,
    fbank_features,
    import_deepspeaker_h5,
    normalize_frames,
    speaker_features_from_audio,
    trim_silence,
)
from styler_tpu_torch.speaker.rescnn import ConvResStage, SameConv2d
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)
from tests.test_vocoder_speaker import _flax_tree_from, _rand_ds_weights

VAL_WAVS = [f"assets/vocoder/val/val_000{i}.wav" for i in range(4)]
ASSET = "assets/speaker/encoder_gen.npz"


def _signal(seconds, seed):
    """A seeded voiced-like signal: harmonics of a gliding f0, a noise floor
    and a quiet lead-in and tail for the silence trim."""
    rng = np.random.default_rng(seed)
    n = int(22050 * seconds)
    t = np.arange(n) / 22050
    f0 = 110 + 40 * seed + 20 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 22050
    x = sum(0.3 / h * np.sin(h * phase) for h in range(1, 8))
    x = x * np.clip(np.minimum(t, t[-1] - t) * 8, 0, 1) + 0.01 * rng.standard_normal(n)
    return x.astype(np.float32)


# 0.5 s: ~50 fbank frames (zero-padded to 160); 3 s: ~300 (cropped)
SIGNALS = {"short": (0.5, 1), "long": (3.0, 2)}


@pytest.mark.parametrize("which", sorted(SIGNALS))
def test_fbank_and_normalisation(which):
    x = _signal(*SIGNALS[which])
    want = jfeat.fbank_features(x, 22050, winlen=1024 / 22050)
    got = fbank_features(x, 22050, winlen=1024 / 22050)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(normalize_frames(got), jfeat.normalize_frames(want))


@pytest.mark.parametrize("which", sorted(SIGNALS))
def test_trim_silence(which):
    x = _signal(*SIGNALS[which])
    got = trim_silence(x)
    np.testing.assert_array_equal(got, jfeat.trim_silence(x))
    assert 0 < len(got) < len(x)


@pytest.mark.parametrize("which", sorted(SIGNALS))
@pytest.mark.parametrize("seeded", [False, True])
def test_features_crop_and_pad(which, seeded):
    """The default crop start is drawn from ``default_rng(0)`` on both
    sides, so both packages embed the same 160 frames."""
    x = _signal(*SIGNALS[which])
    rng = (lambda: np.random.default_rng(7)) if seeded else (lambda: None)
    got = speaker_features_from_audio(x, 22050, 1024, rng=rng())
    want = jfeat.speaker_features_from_audio(x, 22050, 1024, rng=rng())
    assert got.shape == want.shape == (NUM_FRAMES, 64, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    frames = len(fbank_features(trim_silence(x), 22050, winlen=1024 / 22050))
    assert (frames > NUM_FRAMES) == (which == "long")


# ---------------------------------------------------------------------------
# one stride-2 stage: asymmetric 'SAME' padding on an even size
# ---------------------------------------------------------------------------

STAGE_SIZES = ((20, 64), (21, 33))  # even: pads (1, 2); odd: (2, 2)


def _stage_weights():
    w = _rand_ds_weights(np.random.default_rng(3), stages=(16,), in_ch=1)["stage_1"]
    params, stats = _flax_tree_from({"stage_1": w, "affine": w}, stages=1)
    return params["stage_1"], stats["stage_1"]


def _stage_input(T, W):
    return np.random.default_rng(T * 100 + W).standard_normal((2, T, W, 1)).astype(np.float32)


def _jax_stage_golden():
    params, stats = _stage_weights()
    fn = jax.jit(JConvResStage(16).apply)
    return {f"{T}x{W}": np.asarray(fn({"params": params, "batch_stats": stats},
                                      jnp.asarray(_stage_input(T, W))))
            for T, W in STAGE_SIZES}


@pytest.fixture(scope="module")
def jstage(tmp_path_factory):
    return golden(tmp_path_factory, "speaker_stage", _jax_stage_golden)


@pytest.mark.parametrize("T,W", STAGE_SIZES)
def test_stride2_stage(jstage, T, W):
    stage = ConvResStage(1, 16, 3)
    load_flax_tree(stage, *_stage_weights())
    stage.eval()
    with torch.no_grad():
        got = stage(torch.from_numpy(_stage_input(T, W)).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = jstage[f"{T}x{W}"]
    assert got.shape == want.shape == (2, -(-T // 2), -(-W // 2), 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n", [7, 8, 9, 10, 160])
def test_same_padding_output_size(n):
    """ceil(n / 2) outputs at stride 2 and n at stride 1, on both axes."""
    x = torch.zeros(1, 2, n, n + 1)
    assert SameConv2d(2, 3, 5, stride=2)(x).shape == (1, 3, -(-n // 2), -(-(n + 1) // 2))
    assert SameConv2d(2, 3, 3)(x).shape == (1, 3, n, n + 1)


# ---------------------------------------------------------------------------
# the trained encoder and the embedder's tiers
# ---------------------------------------------------------------------------


def _features_batch():
    return [_signal(1.0 + 0.4 * i, 10 + i) for i in range(3)]


def _jax_encoder_golden():
    """The JAX SpeakerEmbedder (trained asset) on the four val wavs, the
    flax SpeakerEncoder on a batch of three seeded feature crops, and the
    fallback tier on the val wavs."""
    cfg = j_config()
    emb = JSpeakerEmbedder(cfg, backend="native")
    fallback = JSpeakerEmbedder(cfg, backend="fallback")
    params, stats = j_load_npz(ASSET)
    feats = np.stack([jfeat.speaker_features_from_audio(x, 22050, 1024) for x in _features_batch()])
    return {
        "embed_wav": [np.asarray(emb.embed_wav(read_wav(p)[0])) for p in VAL_WAVS],
        "fallback": [np.asarray(fallback.embed_wav(read_wav(p)[0])) for p in VAL_WAVS],
        "batch": np.asarray(jax.jit(JSpeakerEncoder().apply)(
            {"params": params, "batch_stats": stats}, jnp.asarray(feats))),
    }


@pytest.fixture(scope="module")
def jenc(tmp_path_factory):
    return golden(tmp_path_factory, "speaker_encoder", _jax_encoder_golden)


@pytest.fixture(scope="module")
def native():
    return SpeakerEmbedder(default_config(), backend="native", device="cpu")


def test_encoder_asset_loads_every_leaf(native):
    assert isinstance(native.model, SpeakerEncoder)
    p, s = to_flax_tree(native.model)
    wp, ws = load_acoustic_npz(ASSET)
    fp, fs, fwp, fws = (flatten_tree(t) for t in (p, s, wp, ws))
    assert len(fp) + len(fs) == 92 and set(fp) == set(fwp) and set(fs) == set(fws)
    for k in fwp:
        np.testing.assert_array_equal(fp[k], fwp[k])
    assert sum(t.numel() for t in native.model.parameters()) == 1559104


def test_encoder_batch_layout(jenc, native):
    """[B, T, 64, 1] features as NCHW [B, 1, T, 64]; the affine reads the
    (width, channel) flatten with the channel fastest, as flax does."""
    feats = np.stack([speaker_features_from_audio(x, 22050, 1024) for x in _features_batch()])
    with torch.no_grad():
        got = native.model(torch.from_numpy(feats).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (3, 512)
    np.testing.assert_allclose(got, jenc["batch"], rtol=0, atol=2e-5)


@pytest.mark.parametrize("i", range(4))
def test_embed_wav_matches_jax(jenc, native, i):
    got = native.embed_wav(read_wav(VAL_WAVS[i])[0])
    want = jenc["embed_wav"][i]
    assert got.shape == want.shape == (1, 512) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("i", range(4))
def test_fallback_tier_bit_equal(jenc, i):
    emb = SpeakerEmbedder(default_config(), backend="fallback", device="cpu")
    assert emb.model is None
    got = emb.embed_wav(read_wav(VAL_WAVS[i])[0])
    assert got.shape == (1, 512) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jenc["fallback"][i])


def test_embeddings_tell_the_val_speakers_apart(jenc):
    e = np.concatenate(jenc["embed_wav"])
    cos = e @ e.T
    assert 1.0 - cos[np.triu_indices(4, 1)].max() > 1e-3


def test_tier_resolution_and_errors(monkeypatch, tmp_path):
    cfg = default_config().replace(speaker_embedder_dir=str(tmp_path / "missing.h5"))
    with pytest.raises(ValueError, match="unknown speaker backend"):
        SpeakerEmbedder(cfg, backend="tflite", device="cpu")
    with pytest.raises(FileNotFoundError, match="missing.h5"):
        SpeakerEmbedder(cfg, backend="h5", device="cpu")
    assert isinstance(SpeakerEmbedder(cfg, device="cpu").model, SpeakerEncoder)
    monkeypatch.setattr(vctk, "default_speaker_asset", lambda: None)
    with pytest.raises(FileNotFoundError, match="encoder_gen.npz"):
        SpeakerEmbedder(cfg, backend="native", device="cpu")
    assert SpeakerEmbedder(cfg, device="cpu").model is None  # auto -> fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SpeakerEmbedder(cfg)


def test_default_speaker_asset():
    assert os.path.samefile(vctk.default_speaker_asset(), ASSET)


# ---------------------------------------------------------------------------
# ResCNN at full width through the Keras .h5 importer
# ---------------------------------------------------------------------------


def _write_h5(path, w, stages=(64, 128, 256, 512)):
    """A Keras-layout ResCNN checkpoint (layer names of conv_models.py:85-120)."""
    import h5py

    with h5py.File(path, "w") as f:
        root = f.create_group("model_weights")

        def put(layer, names_arrays):
            g = root.create_group(layer).create_group(layer)
            for n, a in names_arrays:
                g.create_dataset(n, data=a)

        def put_conv(layer, cw):
            put(layer, [("kernel:0", cw["kernel"]), ("bias:0", cw["bias"])])

        def put_bn(layer, bn):
            put(layer, [("gamma:0", bn["scale"]), ("beta:0", bn["bias"]),
                        ("moving_mean:0", bn["mean"]), ("moving_variance:0", bn["var"])])

        for si, fch in enumerate(stages, start=1):
            sw = w[f"stage_{si}"]
            put_conv(f"conv{fch}-s", sw["conv"])
            put_bn(f"conv{fch}-s_bn", sw["bn"])
            for b in range(3):
                bw = sw[f"res_{b}"]
                put_conv(f"res{si}_{b}_branch_2a", bw["conv_2a"])
                put_bn(f"res{si}_{b}_branch_2a_bn", bw["bn_2a"])
                put_conv(f"res{si}_{b}_branch_2b", bw["conv_2b"])
                put_bn(f"res{si}_{b}_branch_2b_bn", bw["bn_2b"])
        put_conv("affine", w["affine"])


def _h5_file(directory):
    path = os.path.join(str(directory), "rescnn.h5")
    _write_h5(path, _rand_ds_weights(np.random.default_rng(5)))
    return path


def _rescnn_input():
    # T = 32: even at every stage, so every stride-2 conv pads (1, 2)
    return (0.5 * np.random.default_rng(6).standard_normal((2, 32, 64, 1))).astype(np.float32)


def _jax_rescnn_golden(directory):
    variables = j_import_h5(_h5_file(directory))
    return np.asarray(jax.jit(JResCNN().apply)(variables, jnp.asarray(_rescnn_input())))


@pytest.fixture(scope="module")
def h5_path(tmp_path_factory):
    pytest.importorskip("h5py")
    return _h5_file(tmp_path_factory.mktemp("h5"))


@pytest.fixture(scope="module")
def jrescnn(tmp_path_factory, h5_path):
    return golden(tmp_path_factory, "speaker_rescnn",
                  lambda: _jax_rescnn_golden(tmp_path_factory.mktemp("jh5")))


def test_h5_importer_leaves_equal_jax(h5_path):
    got, want = import_deepspeaker_h5(h5_path), j_import_h5(h5_path)
    for tree in ("params", "batch_stats"):
        g, w = flatten_tree(got[tree]), flatten_tree(want[tree])
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_rescnn_full_width(jrescnn, h5_path):
    variables = import_deepspeaker_h5(h5_path)
    model = ResCNN()
    load_flax_tree(model, variables["params"], variables["batch_stats"])
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(_rescnn_input()).permute(0, 3, 1, 2)).numpy()
    assert got.shape == jrescnn.shape == (2, 512)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, jrescnn, rtol=0, atol=1e-4)


def test_h5_tier_is_resolved_first(h5_path):
    emb = SpeakerEmbedder(default_config().replace(speaker_embedder_dir=h5_path), device="cpu")
    assert isinstance(emb.model, ResCNN) and not isinstance(emb.model, SpeakerEncoder)
    out = emb.embed_wav(_signal(1.0, 4))
    assert out.shape == (1, 512) and np.isfinite(out).all()


# ---------------------------------------------------------------------------
# core/convert.py: the Conv2d and BatchNorm2d rules
# ---------------------------------------------------------------------------


def _random_small(seed):
    m = ResCNN(filters=(4, 8), n_blocks=1, embed_dim=16)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in list(m.parameters()) + [b for n, b in m.named_buffers() if "running" in n]:
            t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
    return m.eval()


def test_conv2d_batchnorm2d_round_trip():
    src = _random_small(0)
    params, stats = to_flax_tree(src)
    assert params["stage_1"]["conv"]["kernel"].shape == (5, 5, 1, 4)  # [kh, kw, in, out]
    assert params["stage_2"]["res_0"]["conv_2a"]["kernel"].shape == (3, 3, 8, 8)
    assert set(stats["stage_1"]["bn"]) == {"mean", "var"}
    assert set(params["stage_1"]["bn"]) == {"scale", "bias"}
    np.testing.assert_array_equal(params["stage_1"]["conv"]["kernel"],
                                  src.stage_1.conv.weight.detach().numpy().transpose(2, 3, 1, 0))
    dst = _random_small(1)
    used_p, used_s = load_flax_tree(dst, params, stats)
    assert len(used_p) == len(flatten_tree(params)) and len(used_s) == len(flatten_tree(stats))
    for (name, a), (_, b) in zip(src.state_dict().items(), dst.state_dict().items()):
        if "num_batches_tracked" not in name:
            assert torch.equal(a, b), name
    x = torch.randn(2, 1, 12, 64)
    with torch.no_grad():
        assert torch.equal(src(x), dst(x))


def test_conv2d_rule_refuses_a_bad_tree():
    params, stats = to_flax_tree(_random_small(0))
    params["stage_1"]["conv"]["extra"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="not loaded"):
        load_flax_tree(_random_small(1), params, stats)
    del params["stage_1"]["conv"]["extra"]
    del stats["stage_2"]["bn"]["var"]
    with pytest.raises(KeyError, match="stage_2/bn/var"):
        load_flax_tree(_random_small(1), params, stats)
    params2, stats2 = to_flax_tree(_random_small(0))
    params2["stage_1"]["conv"]["kernel"] = params2["stage_1"]["conv"]["kernel"].transpose(3, 2, 0, 1)
    with pytest.raises(ValueError, match="does not fit"):
        load_flax_tree(_random_small(1), params2, stats2)


def test_conv2d_gradients_under_flax_names():
    m = _random_small(0)
    m(torch.randn(2, 1, 12, 64)).sum().backward()
    grads, _ = to_flax_tree(m, grads=True)
    assert grads["stage_1"]["conv"]["kernel"].shape == (5, 5, 1, 4)
    np.testing.assert_array_equal(grads["stage_1"]["conv"]["kernel"],
                                  m.stage_1.conv.weight.grad.numpy().transpose(2, 3, 1, 0))
