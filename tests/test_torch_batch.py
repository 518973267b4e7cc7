"""The port's ``Synthesizer.synthesize_batch``, ``synthesize`` with non-unit
controls and with a ``noisy=True`` reference, and ``warmup``, against the
JAX package at the small buckets of tests/test_synthesis.py (src 32,
mel 64), on the committed assets and committed validation wavs. The
contracts mirror tests/test_synthesis.py (``test_controls_change_duration``,
``test_synthesize_batch_matches_single``, ``test_batch_clamps_long_inputs``).

Both sides get the same reference features (the JAX package's).

Tolerances:
- mels, f0 and energy: exact f32 on both sides with sums in another order,
  1e-4 of each output's scale (``max(max |x|, 1)``), as
  tests/test_torch_synthesis.py; the batch rows against the port's own
  single requests within 2e-4 abs + 1e-4 rel (tests/test_synthesis.py's).
- ``mel_len``, ``truncated`` and the warmup count: exact.
- waveforms (bf16 vocoder; the JAX package's unfused flax path on the CPU
  rounds its carry to bf16 after every conv): the mean absolute log-mel
  difference below 0.1 (natural log), as tests/test_torch_synthesis.py.
- the noisy (RAPT-tier) f0 of the reference: bit-equal (the same numpy
  code on both sides).

The JAX side's outputs are computed once per session (``golden``). The
helpers here (references, speaker embeddings, comparisons) are shared
with tests/test_torch_long.py and tests/test_torch_mix.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from styler_tpu.core.config import default_config as j_config
from styler_tpu.data.audio_io import read_wav_int
from styler_tpu.synthesis import extract_reference_features as j_extract
from styler_tpu.synthesis import load_synthesizer as j_load_synthesizer
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.dsp.mel import MelFrontend
from styler_tpu_torch.synthesis import ReferenceFeatures, load_synthesizer
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)

SMALL = dict(src_buckets=(32,), mel_buckets=(64,))
SENTENCES = ["Hi.", "The quick brown fox jumps over."]
CONTROLS = [(1.3, 0.8, 1.2), (0.7, 1.25, 0.9)]
LONG_SENTENCE = "The quick brown fox jumps over the lazy dog " * 4
FEATURES = ("mel", "mel_noisy", "f0", "energy")


def spk_embed(seed):
    e = np.random.default_rng(seed).standard_normal(512).astype(np.float32)
    return e / np.linalg.norm(e)


def _wav(name):
    sr, data = read_wav_int(f"assets/vocoder/val/{name}.wav")
    assert sr == 22050
    return data.astype(np.float32)


def jax_refs(jsynth):
    """The JAX package's features of the test references, as plain dicts:
    a whole validation wav (trimmed to the 64-frame bucket), a 0.6 s one
    (shorter than the bucket) and the noisy (RAPT) tier of a third."""
    refs = {
        "a": j_extract(_wav("val_0001"), jsynth.config, jsynth.frontend),
        "b": j_extract(_wav("val_0003")[:14000], jsynth.config, jsynth.frontend),
        "noisy": j_extract(_wav("val_0002"), jsynth.config, jsynth.frontend, noisy=True),
    }
    return {k: {f: np.asarray(v) if f != "mel_len" else int(v)
                for f, v in dataclasses.asdict(r).items()} for k, r in refs.items()}


def jax_synthesizer():
    return j_load_synthesizer(j_config().replace(**SMALL))


def np_out(out):
    """A result dict with only numpy / Python values (no encodings)."""
    return {k: v if isinstance(v, (int, bool, np.bool_)) else np.asarray(v)
            for k, v in out.items() if k != "encodings"}


def close(got, want, rel=1e-4):
    want = np.asarray(want, np.float64)
    assert np.shape(got) == want.shape
    scale = max(np.abs(want).max(), 1.0)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rel * scale, (err, scale)


def log_mel_mae(a, b):
    fe = MelFrontend(default_config())
    return float(np.abs(fe(a)[0] - fe(np.asarray(b))[0]).mean())


def _long_ref():
    """A reference past the 64-frame bucket, given directly."""
    return ReferenceFeatures(
        mel=np.zeros((100, 80), np.float32), f0_norm=np.full(100, 0.5, np.float32),
        energy01=np.full(100, 0.5, np.float32), mel_len=100,
    )


def _jax_golden():
    from styler_tpu.synthesis import ReferenceFeatures as JRef

    jsynth = jax_synthesizer()
    refs = jax_refs(jsynth)
    ra, rb, rn = (JRef(**refs[k]) for k in ("a", "b", "noisy"))
    long_ref = JRef(**dataclasses.asdict(_long_ref()))
    return {
        "refs": refs,
        "batch": [np_out(r) for r in jsynth.synthesize_batch(
            SENTENCES, [ra, rb], [spk_embed(0), spk_embed(1)])],
        "clamped": [np_out(r) for r in jsynth.synthesize_batch(
            [LONG_SENTENCE, SENTENCES[0]], [long_ref, ra], [spk_embed(0)] * 2)],
        "controls": [np_out(jsynth.synthesize(SENTENCES[1], ra, spk_embed(0), *c))
                     for c in CONTROLS],
        "durations": [jsynth.synthesize(SENTENCES[0], ra, spk_embed(0), d_control=d)["mel_len"]
                      for d in (1.6, 0.4)],
        "noisy": np_out(jsynth.synthesize(SENTENCES[1], rn, spk_embed(0))),
        "warmup": jsynth.warmup(),
    }


@pytest.fixture(scope="module")
def jgold(tmp_path_factory):
    return golden(tmp_path_factory, "serving_batch", _jax_golden)


@pytest.fixture(scope="module")
def refs(jgold):
    return {k: ReferenceFeatures(**v) for k, v in jgold["refs"].items()}


@pytest.fixture(scope="module")
def tsynth():
    return load_synthesizer(default_config().replace(**SMALL), device="cpu")


@pytest.fixture(scope="module")
def batch(tsynth, refs):
    return tsynth.synthesize_batch(SENTENCES, [refs["a"], refs["b"]], [spk_embed(0), spk_embed(1)])


def test_batch_contract(batch, jgold):
    assert len(batch) == len(jgold["batch"]) == 2
    for t, j in zip(batch, jgold["batch"]):
        assert set(t) == set(j) == set(FEATURES) | {"wav", "wav_noisy", "mel_len", "truncated"}
        assert t["mel_len"] == j["mel_len"] > 0
        assert t["truncated"] is False and not j["truncated"]
        assert t["wav"].shape == t["wav_noisy"].shape == (t["mel_len"] * 256,)


@pytest.mark.parametrize("row", [0, 1])
@pytest.mark.parametrize("key", FEATURES)
def test_batch_features(batch, jgold, row, key):
    close(batch[row][key], jgold["batch"][row][key])


@pytest.mark.parametrize("row", [0, 1])
@pytest.mark.parametrize("key", ["wav", "wav_noisy"])
def test_batch_waveforms(batch, jgold, row, key):
    assert np.isfinite(batch[row][key]).all()
    assert log_mel_mae(batch[row][key], jgold["batch"][row][key]) < 0.1


@pytest.mark.parametrize("row", [0, 1])
def test_synthesize_batch_matches_single(tsynth, refs, batch, row):
    """Each batch row is the single request of its sentence, reference and
    speaker: the same forward, the batch axis only (rows of different
    lengths, so the padding and the masks are exercised)."""
    single = tsynth.synthesize(SENTENCES[row], refs["ab"[row]], spk_embed(row))
    assert batch[row]["mel_len"] == single["mel_len"]
    for key in FEATURES:
        np.testing.assert_allclose(batch[row][key], single[key], atol=2e-4, rtol=1e-4)


def test_batch_clamps_long_inputs(tsynth, refs, jgold):
    """An over-long sentence and an over-long reference are clamped to the
    largest buckets, and the row says so."""
    res = tsynth.synthesize_batch([LONG_SENTENCE, SENTENCES[0]], [_long_ref(), refs["a"]],
                                  [spk_embed(0)] * 2)
    assert [r["truncated"] for r in res] == [j["truncated"] for j in jgold["clamped"]] == [True, False]
    for t, j in zip(res, jgold["clamped"]):
        assert t["mel_len"] == j["mel_len"]
        assert np.isfinite(t["wav"]).all()
        close(t["mel"], j["mel"])


def test_batch_mesh_raises(tsynth, refs):
    with pytest.raises(NotImplementedError, match=r"Queue 1 \[16\]"):
        tsynth.synthesize_batch(SENTENCES[:1], [refs["a"]], [spk_embed(0)], mesh=object())


@pytest.fixture(scope="module")
def controlled(tsynth, refs):
    return [tsynth.synthesize(SENTENCES[1], refs["a"], spk_embed(0), *c) for c in CONTROLS]


@pytest.mark.parametrize("case", range(len(CONTROLS)))
@pytest.mark.parametrize("key", FEATURES + ("duration",))
def test_controls_match_jax(controlled, jgold, case, key):
    """d, p, e controls other than 1.0: durations scale before rounding,
    pitch and energy predictions scale before their bin lookups."""
    t, j = controlled[case], jgold["controls"][case]
    assert t["mel_len"] == j["mel_len"] > 0
    close(t[key], j[key])


@pytest.mark.parametrize("case", range(len(CONTROLS)))
def test_controls_waveforms(controlled, jgold, case):
    assert log_mel_mae(controlled[case]["wav"], jgold["controls"][case]["wav"]) < 0.1


def test_controls_change_duration(tsynth, refs, jgold):
    slow, fast = (tsynth.synthesize(SENTENCES[0], refs["a"], spk_embed(0), d_control=d)["mel_len"]
                  for d in (1.6, 0.4))
    assert [slow, fast] == jgold["durations"]
    assert slow >= fast


def test_noisy_reference_features(refs, jgold, tsynth):
    """The noisy (RAPT) tier of the reference front end."""
    from styler_tpu_torch.synthesis import extract_reference_features

    t = extract_reference_features(_wav("val_0002"), tsynth.config, tsynth.frontend, noisy=True)
    j = refs["noisy"]
    assert t.mel_len == j.mel_len
    np.testing.assert_array_equal(t.f0_norm, j.f0_norm)
    np.testing.assert_allclose(t.energy01, j.energy01, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def noisy(tsynth, refs):
    return tsynth.synthesize(SENTENCES[1], refs["noisy"], spk_embed(0))


@pytest.mark.parametrize("key", FEATURES + ("duration",))
def test_noisy_reference_request(noisy, jgold, key):
    assert noisy["mel_len"] == jgold["noisy"]["mel_len"] > 0
    close(noisy[key], jgold["noisy"][key])


def test_noisy_reference_waveform(noisy, jgold):
    assert log_mel_mae(noisy["wav_noisy"], jgold["noisy"]["wav_noisy"]) < 0.1


def test_warmup_counts_every_bucket(tsynth, jgold):
    """One forward per (batch, src bucket, mel bucket)."""
    assert tsynth.warmup() == jgold["warmup"] == 1
    assert tsynth.warmup(batches=(1, 2)) == 2
    assert torch.is_grad_enabled()  # the serving methods leave autograd as they found it
