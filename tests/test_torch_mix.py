"""The port's ``Synthesizer.inspect`` (the ten-row ablation grid) and
``mix_and_match`` (the 32 source combinations), and the encode and decode
pieces under them, against the JAX package at the small buckets of
tests/test_synthesis.py (src 32, mel 64), mirroring its
``test_inspection_grid``, ``test_mix_and_match_32_combos``,
``test_encode_style_matches_full_forward`` and
``test_mixed_decode_bucket_invariance``.

Both methods hand back their mel, f0 and energy through float16 and their
wav through int16, as the JAX package does. To hold them to the JAX
package's values before that rounding, the JAX side runs its own
``inspect`` and ``mix_and_match`` with ``_compress`` overridden, in a
subclass made here, to trim without the casts.

Tolerances:
- titles, ``mel_len``: exact;
- mel, f0, energy (port float16 against JAX float32): float16's half ulp,
  ``2**-11 * scale + 1e-4`` (scale = max |x| of the row; the 1e-4 holds
  the f32 sums' other order, ~1e-6 of the scale);
- the grid's ``T+D+P+E+S`` / ``T+D+P+E+S+N`` rows against the clean /
  noisy mel of ``synthesize``, and mix's ``00000`` / ``11111`` rows against
  the single requests of (text 0, ref 0) / (text 1, ref 1): the same bound;
- waveforms (int16 of the bf16 vocoder's output): the mean absolute
  log-mel difference below 0.1 (natural log);
- encodings of ``encode_style`` against the full forward's: 1e-5 abs +
  1e-5 rel (tests/test_synthesis.py's), and against JAX 1e-4 of the scale;
- the mixed decode at mel bucket 64 and 128: 2e-4 abs + 1e-4 rel on the
  valid frames (tests/test_synthesis.py's).
"""

import numpy as np
import pytest
import torch

from styler_tpu.synthesis import ReferenceFeatures as JRef
from styler_tpu.synthesis import Synthesizer as JSynthesizer
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.synthesis import ReferenceFeatures, load_synthesizer
from tests.test_torch_batch import (
    SMALL,
    close,
    jax_refs,
    jax_synthesizer,
    log_mel_mae,
    spk_embed,
)
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)

MIX_SENTENCES = ("Hi.", "No.")
INSPECT_TITLES = ["T+D+P+E+S+N", "T+D+P+E+N", "T+D+P+N", "T+D+N", "T+N",
                  "T", "T+D", "T+D+P", "T+D+P+E", "T+D+P+E+S"]


class _UncastSynthesizer(JSynthesizer):
    """The JAX Synthesizer with ``_compress`` trimming only: values stay
    f32, the wav scaled by 32767 without rounding (``_unpack_results``
    divides it back)."""

    def _compress(self, mel_postnet, wav, p_pred, e_pred, n):
        return (mel_postnet[:, :n], wav[:, : n * self.config.hop_length] * 32767.0,
                p_pred[:, :n], e_pred[:, :n])


def _np_grid(grid):
    return {t: {k: np.asarray(v) if k != "mel_len" else int(v) for k, v in g.items()}
            for t, g in grid.items()}


def _jax_golden():
    jsynth = jax_synthesizer()
    jsynth.__class__ = _UncastSynthesizer
    refs = jax_refs(jsynth)
    ra, rb = JRef(**refs["a"]), JRef(**refs["b"])
    enc, src_mask, mel_len = jsynth._encode(
        *jsynth._pack_rows([jsynth.text_to_ids("Hi.")], [ra], [spk_embed(0)]),
        1.0, 1.0, 1.0, SMALL["mel_buckets"][-1],
    )
    return {
        "refs": refs,
        "encode": ({k: np.asarray(v) for k, v in enc.items()}, np.asarray(src_mask),
                   np.asarray(mel_len)),
        "inspect": _np_grid(jsynth.inspect("Hi.", ra, spk_embed(0))),
        "mix": _np_grid(jsynth.mix_and_match(MIX_SENTENCES, (ra, rb), (spk_embed(0), spk_embed(1)))),
    }


@pytest.fixture(scope="module")
def jgold(tmp_path_factory):
    return golden(tmp_path_factory, "serving_mix", _jax_golden)


@pytest.fixture(scope="module")
def refs(jgold):
    return {k: ReferenceFeatures(**v) for k, v in jgold["refs"].items()}


@pytest.fixture(scope="module")
def tsynth():
    return load_synthesizer(default_config().replace(**SMALL), device="cpu")


@pytest.fixture(scope="module")
def single(tsynth, refs):
    """The single requests the grid and the mix are held to."""
    return {(a, r): tsynth.synthesize(MIX_SENTENCES[a], refs["ab"[r]], spk_embed(r))
            for a, r in ((0, 0), (1, 1))}


@pytest.fixture(scope="module")
def grid(tsynth, refs):
    return tsynth.inspect("Hi.", refs["a"], spk_embed(0))


@pytest.fixture(scope="module")
def mix(tsynth, refs):
    return tsynth.mix_and_match(MIX_SENTENCES, (refs["a"], refs["b"]), (spk_embed(0), spk_embed(1)))


def _f16_close(got, want):
    """Within float16's half ulp of the f32 value (module docstring)."""
    want = np.asarray(want, np.float64)
    assert np.shape(got) == want.shape
    err = np.abs(np.asarray(got, np.float64) - want).max()
    bound = 2.0 ** -11 * np.abs(want).max() + 1e-4
    assert err <= bound, (err, bound)


def test_inspection_grid(grid, jgold):
    assert list(grid) == INSPECT_TITLES == list(jgold["inspect"])
    for title, g in grid.items():
        j = jgold["inspect"][title]
        assert set(g) == set(j) == {"mel", "wav", "f0", "energy", "mel_len"}
        assert g["mel_len"] == j["mel_len"] > 0, title
        assert g["mel"].shape == (g["mel_len"], 80) and g["mel"].dtype == np.float32, title
        assert g["wav"].shape == (g["mel_len"] * 256,) and np.isfinite(g["wav"]).all(), title


@pytest.mark.parametrize("title", INSPECT_TITLES)
@pytest.mark.parametrize("key", ["mel", "f0", "energy"])
def test_inspection_features(grid, jgold, title, key):
    _f16_close(grid[title][key], jgold["inspect"][title][key])


@pytest.mark.parametrize("title", ["T", "T+D+P+E+S+N"])
def test_inspection_waveforms(grid, jgold, title):
    assert log_mel_mae(grid[title]["wav"], jgold["inspect"][title]["wav"]) < 0.1


def test_inspection_rows_equal_the_request(grid, single):
    """The row with every factor from the reference is the request: clean
    without the noise stream, noisy with it."""
    s = single[(0, 0)]
    assert grid["T+D+P+E+S"]["mel_len"] == grid["T+D+P+E+S+N"]["mel_len"] == s["mel_len"]
    _f16_close(grid["T+D+P+E+S"]["mel"], s["mel"])
    _f16_close(grid["T+D+P+E+S+N"]["mel"], s["mel_noisy"])


def test_mix_and_match_32_combos(mix, jgold):
    assert list(mix) == [f"{c:05b}" for c in range(32)] == list(jgold["mix"])
    for comb, r in mix.items():
        assert r["mel_len"] == jgold["mix"][comb]["mel_len"] > 0, comb
        assert np.isfinite(r["mel"]).all(), comb
        assert r["wav"].shape[0] == r["mel_len"] * 256, comb
        # int16 on the way: whole multiples of 1/32767
        np.testing.assert_allclose(r["wav"] * 32767.0, np.round(r["wav"] * 32767.0), atol=1e-3)


@pytest.mark.parametrize("comb", [f"{c:05b}" for c in range(32)])
@pytest.mark.parametrize("key", ["mel", "f0", "energy"])
def test_mix_features(mix, jgold, comb, key):
    _f16_close(mix[comb][key], jgold["mix"][comb][key])


@pytest.mark.parametrize("comb", ["00000", "10110"])
def test_mix_waveforms(mix, jgold, comb):
    assert log_mel_mae(mix[comb]["wav"], jgold["mix"][comb]["wav"]) < 0.1


@pytest.mark.parametrize("comb,pair", [("00000", (0, 0)), ("11111", (1, 1))])
def test_mix_rows_equal_the_requests(mix, single, comb, pair):
    s = single[pair]
    assert mix[comb]["mel_len"] == s["mel_len"]
    _f16_close(mix[comb]["mel"], s["mel"])


def test_encode_style_matches_full_forward(tsynth, refs, single, jgold):
    """``encode_style`` (the decode-free encodings producer of inspect and
    mix) gives the full forward's encodings, mask and predicted length,
    and the JAX package's."""
    out = tsynth.synthesize("Hi.", refs["a"], spk_embed(0))
    enc, src_mask, mel_len = tsynth._encode(
        *tsynth._pack_rows([tsynth.text_to_ids("Hi.")], [refs["a"]], [spk_embed(0)]),
        1.0, 1.0, 1.0, SMALL["mel_buckets"][-1],
    )
    j_enc, j_mask, j_len = jgold["encode"]
    np.testing.assert_array_equal(src_mask.numpy(), out["src_mask"])
    np.testing.assert_array_equal(src_mask.numpy(), j_mask)
    assert int(mel_len[0]) == out["mel_len"] == int(j_len[0])
    assert set(enc) == set(out["encodings"]) == set(j_enc)
    for k, v in out["encodings"].items():
        np.testing.assert_allclose(enc[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5)
        close(enc[k].numpy(), j_enc[k])


def test_mixed_decode_bucket_invariance(tsynth, refs):
    """The valid frames of the mixed decode do not depend on the decode
    bucket: what lets mix_and_match decode at the longest base row's
    bucket instead of the largest."""
    out = tsynth.synthesize("Hi.", refs["a"], spk_embed(0))
    enc = out["encodings"]
    args = (enc["t"], enc["t_neck"], enc["d"], enc["s"], enc["e"], enc["n"],
            enc["p_down"], enc["s_down"], torch.from_numpy(out["src_mask"]))
    small = tsynth._inspect_rows(*args, 64)
    big = tsynth._inspect_rows(*args, 128)
    ml_small = (~small[4]).sum(-1).numpy()
    ml_big = (~big[4]).sum(-1).numpy()
    uncapped = [i for i in range(len(ml_small)) if ml_small[i] < 64]
    assert uncapped, "all rows hit the 64-frame cap; the test needs a shorter input"
    for i in uncapped:
        assert ml_small[i] == ml_big[i]
        m = int(ml_small[i])
        for k in (0, 2):  # mel_postnet, p_prediction
            np.testing.assert_allclose(small[k][i, :m].numpy(), big[k][i, :m].numpy(),
                                       atol=2e-4, rtol=1e-4)
