"""The port's host front end and ``Synthesizer.synthesize`` end to end
against the JAX package, at the small buckets of tests/test_synthesis.py
(src 32, mel 64), on the committed assets and a committed validation wav.

Tolerances:
- reference mel: the two FFT libraries differ at f32 rounding, which the
  log compression magnifies near its 1e-5 floor (measured 7.8e-4) -> 2e-3;
  energy and the f0 trackers (same numpy/native code) exact or 1e-5.
- synthesized mels, durations, pitch and energy: exact f32 on both sides,
  1e-4 of each output's scale (measured 1e-6 relative).
- waveforms (bf16 vocoder): on the CPU the JAX Synthesizer runs the
  unfused flax ResBlock1 path, which rounds the residual carry to bf16
  after every conv, while the port keeps it in f32 as the TPU kernel does;
  and bf16 phase makes sample-wise SNR fragile (see test_torch_vocoder.py).
  Compared by the mean absolute log-mel difference: measured 0.020 to
  0.035 -> bound 0.1 (natural log units).
- the HiFi-GAN request (``vocoder_arch="HiFi-GAN"``, the committed trained
  generator): the same mel tolerance; the JAX side runs the unfused flax
  generator in bf16, whose carry rounds differently again, so the
  waveforms are held by log-mel MAE < 0.1 as well.

The JAX side's outputs are computed once per session (``golden``).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from styler_tpu.core.config import default_config as j_config
from styler_tpu.data.audio_io import read_wav_int
from styler_tpu.dsp.pitch import track_f0 as j_track_f0
from styler_tpu.synthesis import extract_reference_features as j_extract
from styler_tpu.synthesis import load_synthesizer as j_load_synthesizer
from styler_tpu.textproc import G2p as JG2p
from styler_tpu.textproc import text_to_sequence as j_text_to_sequence
from styler_tpu.textproc import to_phoneme_string as j_to_phonemes
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.dsp.mel import MelFrontend
from styler_tpu_torch.dsp.pitch import track_f0
from styler_tpu_torch.core.import_torch import import_hifigan_state
from styler_tpu_torch.synthesis import (
    ReferenceFeatures,
    extract_reference_features,
    load_synthesizer,
)
from styler_tpu_torch.vocoder.hifigan import Generator, HiFiGANConfig
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)
from tests.test_torch_hifigan import reference_hifigan

SMALL = dict(src_buckets=(32,), mel_buckets=(64,))
SENTENCES = [
    "Hi.",
    "The quick brown fox jumps over the lazy dog.",
    "Dr. Smith paid $3.50 for 2 apples on May 5th!",
    "Zyxquor blorfed the unpronounceable snarkle.",
]


@pytest.fixture(scope="module")
def wav():
    sr, data = read_wav_int("assets/vocoder/val/val_0001.wav")
    assert sr == 22050
    return data.astype(np.float32)


def _spk():
    e = np.random.default_rng(0).standard_normal(512).astype(np.float32)
    return e / np.linalg.norm(e)


def _np_out(out):
    return {k: (jax.tree_util.tree_map(np.asarray, v) if isinstance(v, dict) else
                v if isinstance(v, int) else np.asarray(v)) for k, v in out.items()}


def _jax_ref(jsynth):
    sr, data = read_wav_int("assets/vocoder/val/val_0001.wav")
    return j_extract(data.astype(np.float32), jsynth.config, jsynth.frontend)


def _jax_golden():
    """The JAX Synthesizer (iSTFTNet): its mel front end, reference
    features and two requests."""
    jsynth = j_load_synthesizer(j_config().replace(**SMALL))
    sr, data = read_wav_int("assets/vocoder/val/val_0001.wav")
    jm, je = jsynth.frontend(data.astype(np.float32)[:30000] / 32768.0)
    ref = _jax_ref(jsynth)
    return {
        "frontend": (np.asarray(jm), np.asarray(je)),
        "ref": {k: np.asarray(v) if k != "mel_len" else int(v)
                for k, v in dataclasses.asdict(ref).items()},
        "outputs": {s: _np_out(jsynth.synthesize(s, ref, _spk())) for s in SENTENCES[:2]},
    }


def _jax_hifigan_golden():
    """The JAX Synthesizer with ``vocoder_arch="HiFi-GAN"``: one request."""
    jsynth = j_load_synthesizer(j_config().replace(**SMALL), vocoder_arch="HiFi-GAN")
    assert jsynth.config.vocoder == "HiFi-GAN"
    return _np_out(jsynth.synthesize(SENTENCES[1], _jax_ref(jsynth), _spk()))


@pytest.fixture(scope="module")
def jgold(tmp_path_factory):
    return golden(tmp_path_factory, "synthesis", _jax_golden)


@pytest.fixture(scope="module")
def jref(jgold):
    return ReferenceFeatures(**jgold["ref"])


@pytest.fixture(scope="module")
def tsynth():
    return load_synthesizer(default_config().replace(**SMALL), device="cpu")


@pytest.fixture(scope="module")
def spk():
    return _spk()


def test_mel_frontend(jgold, wav):
    audio = wav[:30000] / 32768.0
    jm, je = jgold["frontend"]
    tm, te = MelFrontend(default_config())(audio)
    assert tm.shape == np.asarray(jm).shape == (80, 30000 // 256 + 1)
    np.testing.assert_allclose(tm, np.asarray(jm), rtol=0, atol=2e-3)
    np.testing.assert_allclose(te, np.asarray(je), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("robust", [False, True])
def test_f0_numpy_tier(wav, robust):
    x = wav[:20000] / 32768.0
    np.testing.assert_array_equal(
        track_f0(x, robust=robust, backend="numpy"),
        j_track_f0(x, robust=robust, backend="numpy"),
    )


def test_f0_default_tier(wav):
    x = wav[:20000] / 32768.0
    np.testing.assert_array_equal(track_f0(x), j_track_f0(x))


@pytest.mark.parametrize("sentence", SENTENCES)
def test_text_to_ids(tsynth, sentence):
    want = j_text_to_sequence(j_to_phonemes(sentence, JG2p()), ["english_cleaners"])
    np.testing.assert_array_equal(tsynth.text_to_ids(sentence), np.asarray(want, np.int32))


def test_reference_features(jref, tsynth, wav):
    jr = jref
    tr = extract_reference_features(wav, tsynth.config, tsynth.frontend)
    assert tr.mel_len == jr.mel_len == 64  # trimmed to the largest mel bucket
    np.testing.assert_allclose(tr.mel, jr.mel, rtol=0, atol=2e-3)
    np.testing.assert_array_equal(tr.f0_norm, jr.f0_norm)
    np.testing.assert_allclose(tr.energy01, jr.energy01, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def outputs(jgold, jref, tsynth, spk):
    # the same reference features for both
    return {s: (jgold["outputs"][s], tsynth.synthesize(s, jref, spk)) for s in SENTENCES[:2]}


@pytest.mark.parametrize("sentence", SENTENCES[:2])
def test_synthesize_contract(outputs, sentence):
    j, t = outputs[sentence]
    assert set(t) == set(j)
    assert set(t["encodings"]) == set(j["encodings"])
    assert t["mel_len"] == j["mel_len"] > 0
    for k in ("mel", "mel_noisy", "wav", "wav_noisy", "f0", "energy", "duration", "src_mask"):
        assert t[k].shape == np.asarray(j[k]).shape, k
    assert np.isfinite(t["wav"]).all() and np.isfinite(t["wav_noisy"]).all()


@pytest.mark.parametrize("sentence", SENTENCES[:2])
@pytest.mark.parametrize("key", ["mel", "mel_noisy", "duration", "f0", "energy"])
def test_synthesize_features(outputs, sentence, key):
    j, t = outputs[sentence]
    want = np.asarray(j[key], np.float64)
    assert np.abs(t[key] - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("sentence", SENTENCES[:2])
@pytest.mark.parametrize("key", ["wav", "wav_noisy"])
def test_synthesize_waveforms(outputs, sentence, key):
    j, t = outputs[sentence]
    fe = MelFrontend(default_config())
    mae = np.abs(fe(t[key])[0] - fe(np.asarray(j[key]))[0]).mean()
    assert mae < 0.1, mae


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_synthesizer(default_config().replace(**SMALL))


@pytest.mark.parametrize("kw", [
    {"ckpt_path": "ckpt/checkpoint_560000.pth.tar"},
    {"ckpt_path": "random"},
    {"vocoder_path": "assets/vocoder"},  # an orbax directory
])
def test_later_slices_raise(kw):
    with pytest.raises(NotImplementedError, match="later slice"):
        load_synthesizer(default_config().replace(**SMALL), device="cpu", **kw)


def test_hifigan_vocoder_raises(tmp_path):
    """Around the HiFi-GAN path, what the port still refuses: a reference
    ``.pth.tar`` for another arch (MelGAN, WaveGlow: Queue 1 item 15)."""
    path = str(tmp_path / "melgan.pth.tar")
    torch.save({"state_dict": {}}, path)
    with pytest.raises(NotImplementedError, match="later slice"):
        load_synthesizer(default_config().replace(**SMALL), device="cpu",
                         vocoder_path=path, vocoder_arch="MelGAN")


def _vocoder_leaf(synth, name="resblocks_3_2.w2"):
    return dict(synth.generator.named_parameters())[name].detach().clone()


def test_hifigan_reference_checkpoint_loads(tmp_path):
    """A seeded weight-norm reference generator at the default config,
    saved as the reference saves ``generator_universal.pth.tar``."""
    tg = reference_hifigan(HiFiGANConfig(), 4)
    path = str(tmp_path / "generator_universal.pth.tar")
    torch.save({"generator": tg.state_dict()}, path)
    synth = load_synthesizer(default_config().replace(**SMALL), device="cpu", vocoder_path=path)
    assert synth.config.vocoder == "HiFi-GAN" and isinstance(synth.generator, Generator)
    want = import_hifigan_state(tg.state_dict())["resblocks_3_2"]["convs2_1"]["kernel"]
    np.testing.assert_array_equal(_vocoder_leaf(synth)[1].numpy(), want)


def test_hifigan_asset_loads():
    synth = load_synthesizer(default_config().replace(**SMALL), device="cpu",
                             vocoder_path="assets/vocoder/hifigan_gen.npz")
    assert synth.config.vocoder == "HiFi-GAN" and isinstance(synth.generator, Generator)
    assert not synth.generator.quantize


def test_random_vocoder_loads_from_a_seed():
    cfg = default_config().replace(**SMALL)
    a, b = (load_synthesizer(cfg, device="cpu", vocoder_path="random") for _ in range(2))
    assert a.config.vocoder == "HiFi-GAN"
    torch.testing.assert_close(_vocoder_leaf(a), _vocoder_leaf(b), rtol=0, atol=0)
    assert 0.005 < _vocoder_leaf(a).std().item() < 0.02
    istft = load_synthesizer(cfg, device="cpu", vocoder_path="random", vocoder_arch="iSTFTNet")
    assert istft.config.vocoder == "iSTFTNet"


@pytest.fixture(scope="module")
def hifigan(tmp_path_factory, jref, spk):
    tsynth = load_synthesizer(default_config().replace(**SMALL), vocoder_arch="HiFi-GAN",
                              device="cpu")
    assert isinstance(tsynth.generator, Generator)
    j = golden(tmp_path_factory, "synthesis_hifigan", _jax_hifigan_golden)
    return j, tsynth.synthesize(SENTENCES[1], jref, spk)


@pytest.mark.parametrize("key", ["mel", "mel_noisy", "duration", "f0", "energy"])
def test_hifigan_request_features(hifigan, key):
    j, t = hifigan
    assert set(t) == set(j) and t["mel_len"] == j["mel_len"] > 0
    want = np.asarray(j[key], np.float64)
    assert t[key].shape == want.shape
    assert np.abs(t[key] - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("key", ["wav", "wav_noisy"])
def test_hifigan_request_waveforms(hifigan, key):
    j, t = hifigan
    assert t[key].shape == j[key].shape and np.isfinite(t[key]).all()
    fe = MelFrontend(default_config())
    mae = np.abs(fe(t[key])[0] - fe(j[key])[0]).mean()
    assert mae < 0.1, mae


def test_int8_flag_is_read_at_construction(monkeypatch, jref, spk):
    monkeypatch.setenv("STYLER_TPU_INT8_VOCODER", "1")
    cfg = default_config().replace(**SMALL)
    synth = load_synthesizer(cfg, vocoder_arch="HiFi-GAN", device="cpu")
    istft = load_synthesizer(cfg, device="cpu")  # ignored for iSTFTNet
    monkeypatch.setenv("STYLER_TPU_INT8_VOCODER", "0")
    assert synth.int8_vocoder and synth.generator.quantize
    assert not hasattr(istft.generator, "quantize")
    out = synth.synthesize(SENTENCES[0], jref, spk)
    assert np.isfinite(out["wav"]).all() and out["wav"].shape == (out["mel_len"] * 256,)
