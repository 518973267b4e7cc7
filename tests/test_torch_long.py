"""The port's chunked synthesis of sentences past the largest src bucket
(``Synthesizer.synthesize`` -> ``_phoneme_chunks`` + ``_synthesize_long``)
against the JAX package at the small buckets of tests/test_synthesis.py
(src 32, mel 64), mirroring its ``test_long_sentence_chunked`` and
``test_chunked_batch_pads_to_power_of_two``.

Tolerances (as tests/test_torch_batch.py):
- the chunks' phoneme ids, their count and ``mel_len``: exact;
- mels, f0 and energy (exact f32 on both sides): 1e-4 of each output's
  scale;
- waveforms (bf16 vocoder): mean absolute log-mel difference below 0.1.
"""

import numpy as np
import pytest

from styler_tpu.synthesis import ReferenceFeatures as JRef
from styler_tpu.textproc import to_phoneme_string as j_to_phonemes
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.synthesis import ReferenceFeatures, load_synthesizer
from styler_tpu_torch.textproc import to_phoneme_string
from tests.test_torch_batch import (
    SMALL,
    close,
    jax_refs,
    jax_synthesizer,
    log_mel_mae,
    np_out,
    spk_embed,
)
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)

#: 4 chunks at the 32-phoneme bucket (a batch of 4), and 6 (padded to 8)
LONG = {"four": "The quick brown fox jumps over the lazy dog, " * 4,
        "six": "The quick brown fox jumps over the lazy dog, " * 6}
CHUNKED_KEYS = {"mel", "mel_noisy", "wav", "wav_noisy", "f0", "energy", "mel_len", "chunks"}


def _jax_golden():
    jsynth = jax_synthesizer()
    refs = jax_refs(jsynth)
    ref = JRef(**refs["a"])
    return {
        "refs": refs,
        "chunks": {k: [np.asarray(c) for c in jsynth._phoneme_chunks(j_to_phonemes(s, jsynth.g2p))]
                   for k, s in LONG.items()},
        "out": {k: np_out(jsynth.synthesize(s, ref, spk_embed(0))) for k, s in LONG.items()},
    }


@pytest.fixture(scope="module")
def jgold(tmp_path_factory):
    return golden(tmp_path_factory, "serving_long", _jax_golden)


@pytest.fixture(scope="module")
def tsynth():
    return load_synthesizer(default_config().replace(**SMALL), device="cpu")


@pytest.fixture(scope="module")
def ref(jgold):
    return ReferenceFeatures(**jgold["refs"]["a"])


@pytest.fixture(scope="module")
def spied(tsynth, ref):
    """Each long sentence synthesized, with the row count of every
    ``synthesize_batch`` call it made."""
    out = {}
    orig = tsynth.synthesize_batch
    for key, sentence in LONG.items():
        seen = []

        def spy(sentences, *a, **kw):
            seen.append(len(sentences))
            return orig(sentences, *a, **kw)

        tsynth.synthesize_batch = spy
        try:
            out[key] = (tsynth.synthesize(sentence, ref, spk_embed(0)), seen)
        finally:
            del tsynth.synthesize_batch
    return out


@pytest.mark.parametrize("key", list(LONG))
def test_phoneme_chunks_match_jax(tsynth, jgold, key):
    """Cut after the last pause inside each window, every chunk within the
    largest src bucket, nothing lost."""
    chunks = tsynth._phoneme_chunks(to_phoneme_string(LONG[key], tsynth.g2p))
    want = jgold["chunks"][key]
    assert len(chunks) == len(want) > 1
    for c, w in zip(chunks, want):
        np.testing.assert_array_equal(c, w)
        assert len(c) <= SMALL["src_buckets"][-1]
    assert sum(len(c) for c in chunks) == len(tsynth.text_to_ids(LONG[key]))


@pytest.mark.parametrize("key", list(LONG))
def test_long_sentence_chunked(spied, jgold, key):
    out, _ = spied[key]
    j = jgold["out"][key]
    assert set(out) == set(j) == CHUNKED_KEYS
    assert out["chunks"] == j["chunks"] == len(jgold["chunks"][key])
    assert out["mel_len"] == j["mel_len"] > 0
    assert out["mel"].shape == (out["mel_len"], 80)
    assert out["wav"].shape == out["wav_noisy"].shape == (out["mel_len"] * 256,)
    assert np.isfinite(out["wav"]).all() and np.isfinite(out["mel"]).all()


@pytest.mark.parametrize("key", list(LONG))
@pytest.mark.parametrize("field", ["mel", "mel_noisy", "f0", "energy"])
def test_long_sentence_features(spied, jgold, key, field):
    close(spied[key][0][field], jgold["out"][key][field])


@pytest.mark.parametrize("key", list(LONG))
def test_long_sentence_waveform(spied, jgold, key):
    assert log_mel_mae(spied[key][0]["wav"], jgold["out"][key]["wav"]) < 0.1


@pytest.mark.parametrize("key", list(LONG))
def test_chunked_batch_pads_to_power_of_two(spied, key):
    """One batch of the chunks, padded to the next power of two (a 6-chunk
    sentence runs a batch of 8, not of 6)."""
    out, seen = spied[key]
    k = out["chunks"]
    assert seen == [1 << (k - 1).bit_length()]
    assert seen[0] >= k and (key != "six" or seen == [8])
