"""The port's reference loading against the JAX package on the CPU: the MFA
TextGrid reader and alignment (``styler_tpu/data/textgrid.py``),
``audioread`` / ``audiowrite`` (``styler_tpu/data/audio_io.py``) and
``load_reference`` (``styler_tpu/synthesis.py:856-899``).

Tolerances:
- ``audioread`` / ``audiowrite``: the same numpy on both sides -> equal
  arrays and equal files.
- TextGrid phones, durations and the trim span: the same Python on both
  sides -> equal.
- ``load_reference``: those of ``tests/test_torch_synthesis.py`` for the
  reference features (mel 2e-3, f0_norm equal, energy 1e-5, equal mel_len);
  the speaker embedding from the trained encoder within 2e-5 per entry, a
  precomputed npy equal.

The JAX outputs are computed once per session (``golden``).
"""

import dataclasses
import os

import numpy as np
import pytest
from scipy.io import wavfile

from styler_tpu.core.config import default_config as j_config
from styler_tpu.data import audio_io as j_audio_io
from styler_tpu.data.textgrid import alignment_from_file as j_alignment_from_file
from styler_tpu.data.textgrid import read_textgrid as j_read_textgrid
from styler_tpu.dsp.mel import MelFrontend as JMelFrontend
from styler_tpu.synthesis import load_reference as j_load_reference
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.data import audio_io
from styler_tpu_torch.data.textgrid import (
    alignment_from_file,
    format_textgrid,
    get_alignment,
    read_textgrid,
)
from styler_tpu_torch.data.vctk import SpeakerEmbedder
from styler_tpu_torch.dsp.mel import MelFrontend
from styler_tpu_torch.synthesis import load_reference
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)


GRIDS = {
    # silences at both ends and a pause inside
    "both_ends": [(0.0, 0.25, "sil"), (0.25, 0.5, "HH"), (0.5, 0.75, "sp"), (0.75, 1.0, "AY1"),
                  (1.0, 2.0, "sil")],
    # no leading silence; a trailing sp then sil
    "no_lead": [(0.0, 0.131, "DH"), (0.131, 0.2, "AH0"), (0.2, 0.31, "spn"), (0.31, 0.52, "K"),
                (0.52, 0.6, "sp"), (0.6, 0.9, "sil")],
    # two leading silences of different kinds, one phone, silence after
    "lead_kinds": [(0.0, 0.05, ""), (0.05, 0.12, "sp"), (0.12, 0.33, "sil"),
                   (0.33, 0.4711, "OW1"), (0.4711, 0.6, "sil")],
    # frame-rounding edges: ends at half-frame boundaries
    "rounding": [(0.0, 0.0058, "sil"), (0.0058, 0.0174, "S"), (0.0174, 0.2438, "IY1"),
                 (0.2438, 0.25, "sp"), (0.25, 0.3367, "T"), (0.3367, 0.4, "sil")],
}


@pytest.mark.parametrize("name", sorted(GRIDS))
@pytest.mark.parametrize("tiers", [("phones",), ("words", "phones")])
def test_textgrid_alignment(tmp_path, name, tiers):
    path = tmp_path / "x.TextGrid"
    path.write_text(format_textgrid(GRIDS[name], tiers))
    got, want = read_textgrid(str(path)), j_read_textgrid(str(path))
    assert list(got) == list(want) == list(tiers)
    for t in tiers:
        assert [dataclasses.astuple(i) for i in got[t].intervals] == \
               [dataclasses.astuple(i) for i in want[t].intervals]
    for sr, hop in ((22050, 256), (16000, 160)):
        assert alignment_from_file(str(path), sr, hop) == j_alignment_from_file(str(path), sr, hop)


def test_alignment_trims_and_rounds(tmp_path):
    path = tmp_path / "x.TextGrid"
    path.write_text(format_textgrid(GRIDS["both_ends"]))
    phones, durations, start, end = alignment_from_file(str(path), 22050, 256)
    assert phones == ["HH", "sp", "AY1"] and (start, end) == (0.25, 1.0)
    edges = [0.25, 0.5, 0.75, 1.0]
    assert durations == [int(np.round(e * 22050 / 256) - np.round(s * 22050 / 256))
                         for s, e in zip(edges, edges[1:])]


def test_missing_tier_raises(tmp_path):
    path = tmp_path / "x.TextGrid"
    path.write_text(format_textgrid(GRIDS["both_ends"], ("words",)))
    with pytest.raises(ValueError, match="tier 'phones'"):
        alignment_from_file(str(path), 22050, 256)
    assert get_alignment(read_textgrid(str(path))["words"], 22050, 256)[0] == ["HH", "sp", "AY1"]


# ---------------------------------------------------------------------------
# audioread / audiowrite
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("norm", [True, False])
def test_audioread(tmp_path, channels, norm):
    """Mono and stereo int16 wavs, read with and without the -25 dBFS RMS
    normalisation."""
    rng = np.random.default_rng(7 + channels)
    data = (0.3 * rng.standard_normal((4410, channels)) * 32767).astype(np.int16)
    path = str(tmp_path / "x.wav")
    wavfile.write(path, 22050, data[:, 0] if channels == 1 else data)
    got, want = audio_io.audioread(path, norm), j_audio_io.audioread(path, norm)
    assert got[1:] == want[1:] == (22050, 0.2)
    assert got[0].shape == (4410,) and got[0].dtype == want[0].dtype
    np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("scale", [0.05, 3.0])
@pytest.mark.parametrize("norm", [True, False])
def test_audiowrite(tmp_path, scale, norm):
    """The same bytes as the JAX package's writer; with ``norm`` a loud
    signal is also brought under a peak of 1."""
    x = scale * np.random.default_rng(11).standard_normal(3000).astype(np.float32)
    audio_io.audiowrite(x, 22050, str(tmp_path / "a" / "x.wav"), norm)
    j_audio_io.audiowrite(x, 22050, str(tmp_path / "b" / "x.wav"), norm)
    assert (tmp_path / "a" / "x.wav").read_bytes() == (tmp_path / "b" / "x.wav").read_bytes()


# ---------------------------------------------------------------------------
# load_reference
# ---------------------------------------------------------------------------

# name -> (TextGrid intervals or None, precomputed embedding?, noisy)
CASES = {
    "p101_001": (None, False, False),  # whole wav, the encoder
    "p102_001": (GRIDS["both_ends"], True, False),  # trimmed, npy
    "p103_001": (GRIDS["no_lead"], False, True),  # trimmed, encoder, noisy
    "p104_001": (None, True, True),  # whole wav, npy, noisy
}


def _wav(seed, seconds=2.0):
    """Seeded voiced-like int16 audio at 22050 Hz."""
    rng = np.random.default_rng(seed)
    n = int(22050 * seconds)
    t = np.arange(n) / 22050
    f0 = 120 + 15 * seed + 25 * np.sin(2 * np.pi * 1.3 * t)
    phase = 2 * np.pi * np.cumsum(f0) / 22050
    x = sum(0.25 / h * np.sin(h * phase) for h in range(1, 10))
    x = x * (0.6 + 0.4 * np.sin(2 * np.pi * 2.1 * t)) + 0.01 * rng.standard_normal(n)
    return (x * 32767 * 0.8).astype(np.int16)


def _make_refs(root):
    """The reference dir (wavs, TextGrids) and the preprocessed dir (npy
    embeddings) of CASES under ``root``; returns the config's overrides."""
    refs = os.path.join(root, "refs")
    spk_dir = os.path.join(root, "pre", "VCTK", "spker_embed")
    os.makedirs(refs, exist_ok=True)
    os.makedirs(spk_dir, exist_ok=True)
    for i, (name, (grid, npy, _)) in enumerate(sorted(CASES.items())):
        wavfile.write(os.path.join(refs, name + ".wav"), 22050, _wav(i))
        if grid is not None:
            with open(os.path.join(refs, name + ".TextGrid"), "w") as f:
                f.write(format_textgrid(grid))
        if npy:
            e = np.random.default_rng(100 + i).standard_normal((1, 512)).astype(np.float32)
            np.save(os.path.join(spk_dir, f"VCTK-spker_embed-{name.split('_')[0]}.npy"), e)
    return dict(ref_audio_dir=refs, ref_tg_dir=refs, preprocessed_basedir=os.path.join(root, "pre"))


def _jax_golden(root):
    cfg = j_config().replace(**_make_refs(str(root)))
    fe = JMelFrontend(cfg)
    out = {}
    for name, (_, _, noisy) in CASES.items():
        ref, spk = j_load_reference(cfg, fe, name, noisy=noisy)
        out[name] = {"ref": {k: np.asarray(v) if k != "mel_len" else int(v)
                             for k, v in dataclasses.asdict(ref).items()},
                     "spk": np.asarray(spk)}
    return out


@pytest.fixture(scope="module")
def jgold(tmp_path_factory):
    return golden(tmp_path_factory, "reference",
                  lambda: _jax_golden(tmp_path_factory.mktemp("jrefs")))


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    return default_config().replace(**_make_refs(str(tmp_path_factory.mktemp("refs"))))


@pytest.fixture(scope="module")
def loaded(cfg):
    fe = MelFrontend(cfg, "cpu")
    return {name: load_reference(cfg, fe, name, noisy=noisy)
            for name, (_, _, noisy) in CASES.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_load_reference_features(jgold, loaded, name):
    ref, _ = loaded[name]
    want = jgold[name]["ref"]
    assert ref.mel_len == want["mel_len"] > 0
    assert ref.mel.shape == want["mel"].shape == (ref.mel_len, 80)
    np.testing.assert_allclose(ref.mel, want["mel"], rtol=0, atol=2e-3)
    np.testing.assert_array_equal(ref.f0_norm, want["f0_norm"])
    np.testing.assert_allclose(ref.energy01, want["energy01"], rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_load_reference_embedding(jgold, loaded, name):
    _, spk = loaded[name]
    want = jgold[name]["spk"]
    assert spk.shape == want.shape == (1, 512) and spk.dtype == np.float32
    if CASES[name][1]:
        np.testing.assert_array_equal(spk, want)
    else:
        np.testing.assert_allclose(spk, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("name", [n for n in sorted(CASES) if CASES[n][0] is not None])
def test_textgrid_trims_to_the_durations(cfg, loaded, name):
    """The TextGrid's durations set the frames, and the speaker is embedded
    from the trimmed wav."""
    _, durations, start, end = alignment_from_file(
        os.path.join(cfg.ref_tg_dir, name + ".TextGrid"), cfg.sampling_rate, cfg.hop_length)
    ref, spk = loaded[name]
    assert ref.mel_len == sum(durations)
    if not CASES[name][1]:
        sr, wav = wavfile.read(os.path.join(cfg.ref_audio_dir, name + ".wav"))
        trimmed = wav[int(sr * start): int(sr * end)].astype(np.float32) / cfg.max_wav_value
        np.testing.assert_array_equal(
            spk, SpeakerEmbedder(cfg, device="cpu").embed_wav(trimmed))


def test_npy_wins_over_the_encoder_and_speaker_id_picks_it(cfg):
    fe = MelFrontend(cfg, "cpu")
    _, by_name = load_reference(cfg, fe, "p101_001")
    _, by_id = load_reference(cfg, fe, "p101_001", speaker_id="p102")
    want = np.load(os.path.join(cfg.preprocessed_path, "spker_embed", "VCTK-spker_embed-p102.npy"))
    np.testing.assert_array_equal(by_id, want)
    assert not np.array_equal(by_name, want)


def test_missing_reference_raises(cfg):
    with pytest.raises(FileNotFoundError):
        load_reference(cfg, MelFrontend(cfg, "cpu"), "p999_001")
