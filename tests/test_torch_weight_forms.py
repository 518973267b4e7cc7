"""Every acoustic weight form the port reads, on the CPU, against the JAX
package where it has the same form, at the small buckets of
tests/test_synthesis.py (src 32, mel 64):

- ``save_acoustic_npz``: the JAX ``load_acoustic_npz`` reads the port's file
  as the float16-rounded trees, exactly;
- the train -> serve round trip: two CPU steps of the trainer, then its
  ``step_2.pt``, its checkpoint directory and the exporter's ``.npz``
  through ``load_synthesizer``: one request each, bit-equal to a
  Synthesizer built from ``to_flax_tree(state.model)`` (the ``.npz``: from
  its float16-rounded tree);
- the reference's ``checkpoint_<step>.pth.tar``: a seeded reference-layout
  state dict (the importer's layout transforms inverted on a seeded tree,
  with the ``module.`` prefix, a ``pitch_norm_linear`` and BatchNorm step
  counters that must be ignored). The port's ``import_styler_state`` gives
  the JAX importer's leaves bit for bit; both packages' ``load_synthesizer``
  keep HiFi-GAN for it and agree on one request at the f32 tolerances of
  tests/test_torch_synthesis.py (1e-4 of each output's scale; waveforms,
  bf16 vocoder, by log-mel MAE < 0.1);
- ``"random"``: the same weights twice, a finite request;
- the refusals: a directory with no ``step_<N>.pt``, an orbax directory.
"""

import os
import re

import numpy as np
import pytest
import torch

from styler_tpu.core.checkpoint import load_acoustic_npz as j_load_acoustic_npz
from styler_tpu.core.config import default_config as j_config
from styler_tpu.core.import_torch import import_styler_state as j_import_styler_state
from styler_tpu.synthesis import ReferenceFeatures as JReferenceFeatures
from styler_tpu.synthesis import load_synthesizer as j_load_synthesizer
from styler_tpu_torch.core.checkpoint import (
    default_vocoder_asset,
    flatten_tree,
    load_acoustic_npz,
    load_vocoder_npz,
    save_acoustic_npz,
    unflatten_tree,
)
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.core.convert import to_flax_tree
from styler_tpu_torch.dsp.mel import MelFrontend
from styler_tpu_torch.models import STYLER
from styler_tpu_torch.data.audio_io import read_wav_int
from styler_tpu_torch.synthesis import Synthesizer, extract_reference_features, load_synthesizer
from styler_tpu_torch.tools import export_acoustic_asset
from styler_tpu_torch.train.example import write_example_dataset
from styler_tpu_torch.train.state import init_like_flax
from styler_tpu_torch.train.trainer import Trainer
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)
from tests.test_torch_synthesis import SENTENCES, SMALL, _np_out, _spk

REL = 1e-4
#: the narrow widths of tests/test_torch_train_step.py
REDUCED = dict(encoder_layer=1, decoder_layer=1, fft_conv1d_filter_size=256)
#: narrow FFN, two layers in each stack (the importer's per-layer loops)
NARROW = dict(encoder_layer=2, decoder_layer=2, fft_conv1d_filter_size=256)
KEYS = ("mel", "mel_noisy", "wav", "wav_noisy", "f0", "energy", "duration")


def seeded_trees(seed, **widths):
    """Flax-layout (params, batch_stats) of a STYLER drawn from ``seed``,
    with seeded PostNet running statistics (not the init's 0 / 1)."""
    model = STYLER(default_config().replace(**widths))
    init_like_flax(model, torch.Generator().manual_seed(seed))
    params, stats = to_flax_tree(model)
    rng = np.random.default_rng(seed)
    for bn in stats["postnet"].values():
        bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return params, stats


def reference_state_dict(params, stats):
    """The reference's DataParallel STYLER state dict of flax-layout trees:
    the importer's layout transforms inverted (Linear kernel [in, out] ->
    weight [out, in], Conv1d kernel [k, in, out] -> weight [out, in, k],
    norms' scale -> weight, LSTM leaves -> torch's ``weight_ih_l0_reverse``
    names), plus what the importer must ignore."""
    sd = {}

    def lin(dst, t):
        sd[f"{dst}.weight"], sd[f"{dst}.bias"] = t["kernel"].T, t["bias"]

    def conv(dst, t):
        sd[f"{dst}.weight"], sd[f"{dst}.bias"] = t["kernel"].transpose(2, 1, 0), t["bias"]

    def norm(dst, t):
        sd[f"{dst}.weight"], sd[f"{dst}.bias"] = t["scale"], t["bias"]

    def fft(dst, t):
        for n in ("w_qs", "w_ks", "w_vs", "fc"):
            lin(f"{dst}.slf_attn.{n}", t["slf_attn"][n])
        norm(f"{dst}.slf_attn.layer_norm", t["slf_attn"]["layer_norm"])
        conv(f"{dst}.pos_ffn.w_1", t["pos_ffn"]["w_1"])
        conv(f"{dst}.pos_ffn.w_2", t["pos_ffn"]["w_2"])
        norm(f"{dst}.pos_ffn.layer_norm", t["pos_ffn"]["layer_norm"])

    sm, se, ae = params["style_modeling"], "style_modeling.style_encoder", "style_modeling.style_encoder.audio_encoder"
    te = sm["text_encoder"]
    sd[f"{se}.text_encoder.src_word_emb.weight"] = te["src_word_emb"]
    for k, v in te.items():
        if k.startswith("layer_"):
            fft(f"{se}.text_encoder.layer_stack.{k[6:]}", v)
    for n, b in enumerate("dper", start=1):
        for i in range(3):
            conv(f"{ae}.convolutions_{n}.{i}.0.conv", sm["audio_encoder"][f"convs_{b}"][f"conv_{i}"])
            norm(f"{ae}.convolutions_{n}.{i}.1", sm["audio_encoder"][f"convs_{b}"][f"gn_{i}"])
        for k, v in sm["audio_encoder"][f"lstm_{b}"].items():
            layer, d, w, kind = re.fullmatch(r"l(\d)_(fwd|bwd)_([wb])_(ih|hh)", k).groups()
            name = f"{'weight' if w == 'w' else 'bias'}_{kind}_l{layer}{'_reverse' if d == 'bwd' else ''}"
            sd[f"{ae}.lstm_{n}.{name}"] = v
    for n in ("text_linear_down", "speaker_linear_p", "speaker_linear"):
        lin(f"{se}.{n}.0", sm[n])
    lin("style_modeling.text_linear_up.0", sm["text_linear_up"])
    for f in "dpe":
        c, dst = sm[f"augmentation_classifier_{f}"], f"style_modeling.augmentation_classifier_{f}.classifier"
        lin(f"{dst}.d_fc1", c["d_fc1"])
        norm(f"{dst}.d_bn1", c["d_bn1"])
        lin(f"{dst}.d_fc2", c["d_fc2"])
    for f in ("duration", "pitch", "energy", "residual"):
        lin(f"style_modeling.{f}_linear.0", sm[f"{f}_linear"]["fc1"])
        lin(f"style_modeling.{f}_linear.2", sm[f"{f}_linear"]["fc2"])
    for f in ("duration", "pitch", "energy"):
        p, dst = sm[f"{f}_predictor"], f"style_modeling.{f}_predictor"
        for i in (1, 2):
            conv(f"{dst}.conv_layer.conv1d_{i}.conv", p[f"conv1d_{i}"])
            norm(f"{dst}.conv_layer.layer_norm_{i}", p[f"layer_norm_{i}"])
        lin(f"{dst}.linear_layer", p["linear_layer"])
    for f in ("pitch", "energy"):
        sd[f"style_modeling.{f}_embedding.weight"] = sm[f"{f}_embedding"]["embedding"]
    for k, v in params["decoder"].items():
        fft(f"decoder.layer_stack.{k[6:]}", v)
    lin("mel_linear", params["mel_linear"])
    for i in range(5):
        conv(f"postnet.convolutions.{i}.0.conv", params["postnet"][f"conv_{i}"])
        norm(f"postnet.convolutions.{i}.1", params["postnet"][f"bn_{i}"])
        sd[f"postnet.convolutions.{i}.1.running_mean"] = stats["postnet"][f"bn_{i}"]["mean"]
        sd[f"postnet.convolutions.{i}.1.running_var"] = stats["postnet"][f"bn_{i}"]["var"]
        sd[f"postnet.convolutions.{i}.1.num_batches_tracked"] = np.array(560000)
    # dead weight in the reference (modules.py:254-257), never imported
    sd["style_modeling.pitch_norm_linear.0.weight"] = np.ones((256, 128), np.float32)
    sd["style_modeling.pitch_norm_linear.0.bias"] = np.ones(256, np.float32)
    return {f"module.{k}": torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


@pytest.fixture(scope="module")
def ref():
    """The reference features of a committed validation wav (the port's
    front end; the JAX side is given the same numbers)."""
    sr, data = read_wav_int("assets/vocoder/val/val_0001.wav")
    cfg = default_config().replace(**SMALL)
    return extract_reference_features(data.astype(np.float32), cfg, MelFrontend(cfg))


def _f16(tree):
    return unflatten_tree({k: v.astype(np.float16).astype(np.float32)
                           for k, v in flatten_tree(tree).items()})


def _request(synth, ref):
    out = synth.synthesize(SENTENCES[1], ref, _spk())
    return {k: out[k] for k in (*KEYS, "mel_len")}


def _assert_bit_equal(got, want, what):
    assert got["mel_len"] == want["mel_len"] > 0, what
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what}: {k}")


def _iSTFTNet(cfg, params, stats):
    voc = load_vocoder_npz(default_vocoder_asset("iSTFTNet"))
    return Synthesizer(cfg.replace(vocoder="iSTFTNet"), params, stats, voc, "cpu")


def test_save_acoustic_npz_reads_in_jax(tmp_path):
    params, stats = seeded_trees(1, **REDUCED)
    path = str(tmp_path / "a" / "x.npz")
    save_acoustic_npz(path, params, stats)
    for got_p, got_s in (j_load_acoustic_npz(path), load_acoustic_npz(path)):
        for got, want in ((got_p, _f16(params)), (got_s, _f16(stats))):
            got, want = flatten_tree(got), flatten_tree(want)
            assert set(got) == set(want) and any(k.endswith("var") for k in flatten_tree(stats))
            for k, v in want.items():
                np.testing.assert_array_equal(np.asarray(got[k]), v, err_msg=k)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two CPU steps of the trainer at full width (dropout on, fresh
    weights), its checkpoint directory and the state's trees."""
    root = tmp_path_factory.mktemp("train")
    cfg = write_example_dataset(
        str(root / "data"),
        default_config().replace(batch_size=2, log_step=1, src_buckets=(12,), mel_buckets=(48,)),
        4, seed=7, src_len_range=(5, 12), mel_len_range=(20, 48),
    )
    tr = Trainer(cfg, device="cpu", ckpt_dir=str(root / "ckpt"), log_dir=str(root / "log"))
    tr.fit(2, log=lambda _line: None)
    assert tr.state.step == 2 and os.path.exists(root / "ckpt" / "step_2.pt")
    return str(root / "ckpt"), to_flax_tree(tr.state.model)


@pytest.fixture(scope="module")
def cfg_small():
    return default_config().replace(**SMALL)


@pytest.fixture(scope="module")
def trained_want(trained, cfg_small, ref):
    return _request(_iSTFTNet(cfg_small, *trained[1]), ref)


@pytest.mark.parametrize("form", ["step_file", "directory"])
def test_trained_checkpoint_serves(trained, trained_want, cfg_small, ref, form):
    ckpt_dir, _ = trained
    path = os.path.join(ckpt_dir, "step_2.pt") if form == "step_file" else ckpt_dir
    synth = load_synthesizer(cfg_small, ckpt_path=path, device="cpu")
    assert synth.config.vocoder == "iSTFTNet"
    _assert_bit_equal(_request(synth, ref), trained_want, form)


def test_exported_asset_serves(trained, cfg_small, tmp_path, capsys):
    """The exporter's one-line report, and a Synthesizer on its ``.npz``
    whose trees are the state's, float16-rounded."""
    ckpt_dir, (params, stats) = trained
    out = str(tmp_path / "styler_gen.npz")
    assert export_acoustic_asset.main(["--ckpt", ckpt_dir, "--out", out]) == 0
    line = capsys.readouterr().out.strip()
    assert re.fullmatch(rf"wrote {re.escape(out)}: step 2, [\d.]+ M params \(\+\d+ batch-stat "
                        r"scalars\), [\d.]+ MB \(f16 compressed\)", line), line
    synth = load_synthesizer(cfg_small, ckpt_path=out, device="cpu")
    for got, want in zip(to_flax_tree(synth.model), (_f16(params), _f16(stats))):
        got, want = flatten_tree(got), flatten_tree(want)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def reference_ckpt(tmp_path_factory):
    params, stats = seeded_trees(2, **NARROW)
    path = str(tmp_path_factory.mktemp("reference") / "checkpoint_1.pth.tar")
    torch.save({"model": reference_state_dict(params, stats), "optimizer": {}}, path)
    return path, params, stats


def test_import_styler_state_matches_jax(reference_ckpt):
    path, params, stats = reference_ckpt
    sd = torch.load(path, weights_only=True)["model"]
    from styler_tpu_torch.core.import_torch import import_styler_state

    got = import_styler_state(sd, default_config().replace(**NARROW))
    want = j_import_styler_state(sd, j_config().replace(**NARROW))
    for g, w, seeded in zip(got, want, (params, stats)):
        g, w = flatten_tree(g), flatten_tree(w)
        assert set(g) == set(w) == set(flatten_tree(seeded))
        for k in w:
            assert g[k].dtype == np.float32, k
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
            np.testing.assert_array_equal(g[k], flatten_tree(seeded)[k], err_msg=k)


@pytest.fixture(scope="module")
def reference_outputs(reference_ckpt, cfg_small, ref, tmp_path_factory):
    path = reference_ckpt[0]

    def jax_side():
        jsynth = j_load_synthesizer(j_config().replace(**SMALL, **NARROW), ckpt_path=path)
        assert jsynth.config.vocoder == "HiFi-GAN"
        jr = JReferenceFeatures(ref.mel, ref.f0_norm, ref.energy01, ref.mel_len)
        return _np_out(jsynth.synthesize(SENTENCES[1], jr, _spk()))

    synth = load_synthesizer(cfg_small.replace(**NARROW), ckpt_path=path, device="cpu")
    assert synth.config.vocoder == "HiFi-GAN"
    return golden(tmp_path_factory, "reference_ckpt_request", jax_side), _request(synth, ref)


def test_reference_checkpoint_request_matches_jax(reference_outputs):
    j, t = reference_outputs
    assert t["mel_len"] == j["mel_len"] > 0
    for k in ("mel", "mel_noisy", "duration", "f0", "energy"):
        want = np.asarray(j[k], np.float64)
        assert t[k].shape == want.shape, k
        assert np.abs(t[k] - want).max() <= REL * max(np.abs(want).max(), 1.0), k
    fe = MelFrontend(default_config())
    for k in ("wav", "wav_noisy"):
        assert np.abs(fe(t[k])[0] - fe(np.asarray(j[k]))[0]).mean() < 0.1, k


@pytest.mark.parametrize("form", ["reference", "random"])
def test_acoustic_forms_load(reference_ckpt, cfg_small, ref, form):
    """Once refusals of a later slice: a reference ``.pth.tar`` (HiFi-GAN
    kept) and ``"random"`` weights (iSTFTNet promoted) serve a finite
    request of the right shapes; "random" gives the same weights twice."""
    cfg = cfg_small.replace(**NARROW)
    path = reference_ckpt[0] if form == "reference" else "random"
    synth = load_synthesizer(cfg, ckpt_path=path, device="cpu")
    assert synth.config.vocoder == ("HiFi-GAN" if form == "reference" else "iSTFTNet")
    if form == "random":
        again = load_synthesizer(cfg, ckpt_path="random", device="cpu")
        a, b = flatten_tree(to_flax_tree(synth.model)[0]), flatten_tree(to_flax_tree(again.model)[0])
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    out = _request(synth, ref)
    ml = out["mel_len"]
    assert 0 < ml <= 64 and out["mel"].shape == out["mel_noisy"].shape == (ml, 80)
    assert out["wav"].shape == out["wav_noisy"].shape == (ml * 256,)
    for k in KEYS:
        assert np.isfinite(out[k]).all(), k


def test_directory_without_checkpoint_raises(tmp_path, cfg_small):
    with pytest.raises(NotImplementedError, match="no step_<N>.pt"):
        load_synthesizer(cfg_small, ckpt_path=str(tmp_path), device="cpu")
    (tmp_path / "560000").mkdir()  # the JAX trainer's orbax layout
    with pytest.raises(NotImplementedError, match="orbax"):
        load_synthesizer(cfg_small, ckpt_path=str(tmp_path), device="cpu")
