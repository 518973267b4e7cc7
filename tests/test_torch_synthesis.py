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
"""

import numpy as np
import pytest
import torch

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
from styler_tpu_torch.synthesis import extract_reference_features, load_synthesizer

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


@pytest.fixture(scope="module")
def jsynth():
    return j_load_synthesizer(j_config().replace(**SMALL))


@pytest.fixture(scope="module")
def tsynth():
    return load_synthesizer(default_config().replace(**SMALL), device="cpu")


@pytest.fixture(scope="module")
def spk():
    e = np.random.default_rng(0).standard_normal(512).astype(np.float32)
    return e / np.linalg.norm(e)


def test_mel_frontend(jsynth, wav):
    audio = wav[:30000] / 32768.0
    jm, je = jsynth.frontend(audio)
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


def test_reference_features(jsynth, tsynth, wav):
    jr = j_extract(wav, jsynth.config, jsynth.frontend)
    tr = extract_reference_features(wav, tsynth.config, tsynth.frontend)
    assert tr.mel_len == jr.mel_len == 64  # trimmed to the largest mel bucket
    np.testing.assert_allclose(tr.mel, jr.mel, rtol=0, atol=2e-3)
    np.testing.assert_array_equal(tr.f0_norm, jr.f0_norm)
    np.testing.assert_allclose(tr.energy01, jr.energy01, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def outputs(jsynth, tsynth, wav, spk):
    ref = j_extract(wav, jsynth.config, jsynth.frontend)  # same inputs for both
    return {
        s: (jsynth.synthesize(s, ref, spk), tsynth.synthesize(s, ref, spk))
        for s in SENTENCES[:2]
    }


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
    {"vocoder_path": "generator_universal.pth.tar"},
])
def test_later_slices_raise(kw):
    with pytest.raises(NotImplementedError, match="later slice"):
        load_synthesizer(default_config().replace(**SMALL), device="cpu", **kw)


def test_hifigan_vocoder_raises():
    with pytest.raises(NotImplementedError, match="later slice"):
        load_synthesizer(
            default_config().replace(**SMALL), device="cpu",
            vocoder_path="assets/vocoder/hifigan_gen.npz",
        )


def test_long_sentence_raises(tsynth, wav, spk):
    ref = extract_reference_features(wav, tsynth.config, tsynth.frontend)
    with pytest.raises(NotImplementedError, match="chunk"):
        tsynth.synthesize(" ".join(["word"] * 40), ref, spk)
