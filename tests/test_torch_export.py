"""The port's serving bundle (``styler_tpu_torch/core/export.py``,
``python -m styler_tpu_torch.cli.export``, ``serve --bundle``) on the CPU,
against the JAX package's ``core/export.py`` at the buckets of
tests/test_export.py (src 32, mel 64), on the committed trained assets.

On the CPU a bundle call runs the eager forward with the kernels' plain
versions (its CUDA graphs are held on the card in tests/test_torch_cuda.py).

Tolerances, those of tests/test_torch_synthesis.py and for its reasons:
``mel_len`` equal; mels, f0 and energy within 1e-4 of each output's scale
(exact f32 on both sides, sums in another order); waveforms by log-mel MAE
< 0.1 (the JAX bundle runs the unfused flax ResBlock1 path, which rounds
the residual carry to bf16 after every conv; bf16 phase makes sample SNR
fragile). The port against itself (its own export, a JAX-written bundle,
the live ``Synthesizer``, float against tensor controls) is bit-equal.

The JAX bundle (batches 1 and 2) and its outputs are computed once per
session (``golden``): its weights as numpy arrays and its manifest, so a
test writes its own JAX-layout directory from them.
"""

import dataclasses
import json
import logging
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax

from styler_tpu.core.config import default_config as j_config
from styler_tpu.core.export import ServingBundle as JServingBundle
from styler_tpu.core.export import save_serving_bundle as j_save_serving_bundle
from styler_tpu.data.audio_io import read_wav_int
from styler_tpu.synthesis import extract_reference_features as j_extract
from styler_tpu.synthesis import load_synthesizer as j_load_synthesizer
from styler_tpu_torch.cli import export as export_cli
from styler_tpu_torch.cli.serve import Server
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.core.export import (
    FORMAT,
    BundleSynthesizer,
    ServingBundle,
    config_from_json,
    load_flat_weights,
    save_serving_bundle,
    tree_from_leaves,
    tree_leaves,
)
from styler_tpu_torch.dsp.mel import MelFrontend
from styler_tpu_torch.synthesis import load_synthesizer
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(src_buckets=(32,), mel_buckets=(64,))
SENTENCES = ("Hello world.", "Bundle serving on the card.", "A graph per bucket.")


def _jax_golden():
    """The JAX bundle at batches (1, 2): its weights and manifest, the
    shared inputs (reference features of a committed wav, phoneme ids, a
    speaker embedding), one request per sentence and a 3-row batch."""
    jcfg = j_config().replace(**SMALL)
    jsynth = j_load_synthesizer(jcfg)
    _, wav = read_wav_int("assets/vocoder/val/val_0001.wav")
    ref = j_extract(wav.astype(np.float32), jcfg, jsynth.frontend)
    n = int(ref.mel_len)
    inputs = {"mel": np.asarray(ref.mel)[:n], "f0_norm": np.asarray(ref.f0_norm)[:n],
              "energy01": np.asarray(ref.energy01)[:n],
              "ids": [np.asarray(jsynth.text_to_ids(s)) for s in SENTENCES]}
    spk = np.random.default_rng(0).standard_normal(512).astype(np.float32)
    inputs["spk"] = spk / np.linalg.norm(spk)
    with tempfile.TemporaryDirectory() as d:
        manifest = j_save_serving_bundle(jsynth, d, batch=(1, 2), platforms=["cpu"])
        bundle = JServingBundle(d)
        args = (inputs["mel"], inputs["f0_norm"], inputs["energy01"])
        single = [bundle.synthesize(ids, *args, inputs["spk"]) for ids in inputs["ids"]]
        calls = []
        call = bundle.call
        bundle.call = lambda B, L, M, *a: calls.append([B, L, M]) or call(B, L, M, *a)
        batch = bundle.synthesize_batch(inputs["ids"], *([a] * 3 for a in args),
                                        [inputs["spk"]] * 3)
        with np.load(os.path.join(d, "weights.npz")) as z:
            weights = {k: z[k] for k in z.files}

    def host(r):
        return {k: (np.asarray(v) if isinstance(v, jax.Array) else v) for k, v in r.items()}

    return {"manifest": manifest, "weights": weights, "inputs": inputs,
            "single": [host(r) for r in single], "batch": [host(r) for r in batch],
            "calls": calls}


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return golden(tmp_path_factory, "export_jax_bundle", _jax_golden)


@pytest.fixture(scope="module")
def synth():
    return load_synthesizer(default_config().replace(**SMALL), device="cpu")


@pytest.fixture(scope="module")
def bundle_dir(synth, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("port_bundle"))
    manifest = save_serving_bundle(synth, out, batch=(1, 2))
    assert [e["name"] for e in manifest["entries"]] == ["fwd_b1_L32_M64", "fwd_b2_L32_M64"]
    return out


@pytest.fixture(scope="module")
def bundle(bundle_dir):
    return ServingBundle(bundle_dir, device="cpu")


def _args(inputs):
    return inputs["mel"], inputs["f0_norm"], inputs["energy01"]


def _frontend():
    return MelFrontend(default_config(), "cpu")


def _near_jax(got, want, frontend, what):
    """The parity tolerances of the module docstring."""
    assert got["mel_len"] == want["mel_len"], what
    for k in ("mel", "mel_noisy", "f0", "energy"):
        scale = max(1.0, float(np.abs(want[k]).max()))
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= 1e-4 * scale, f"{what} {k}: {err} > 1e-4 x {scale}"
    for k in ("wav", "wav_noisy"):
        assert got[k].shape == want[k].shape
        mae = float(np.abs(frontend(got[k])[0] - frontend(want[k])[0]).mean())
        assert mae < 0.1, f"{what} {k}: log-mel MAE {mae}"


def _assert_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def test_manifest(bundle_dir, synth):
    with open(os.path.join(bundle_dir, "manifest.json")) as f:
        m = json.load(f)
    assert sorted(os.listdir(bundle_dir)) == ["manifest.json", "weights.npz"]  # no programs
    assert m["format"] == FORMAT and m["vocoder"] == "iSTFTNet" and m["vocoder_form"] == "bf16"
    assert m["fused_vocoder"] is True and m["speaker_embed_dim"] == 512
    assert m["audio"] == {"sampling_rate": 22050, "hop_length": 256, "n_mel_channels": 80,
                          "mel_out": 64}
    assert [(e["batch"], e["src_bucket"], e["mel_bucket"]) for e in m["entries"]] == [
        (1, 32, 64), (2, 32, 64)]
    assert config_from_json(m["config"]) == synth.config
    assert m["model_weight_keys"][0] == "m00000" and m["vocoder_weight_keys"][-1] == "v00079"


def test_config_json_round_trip():
    cfg = default_config().replace(src_buckets=(16, 48), text_cleaners=("english_cleaners",))
    back = config_from_json(json.loads(json.dumps(dataclasses.asdict(cfg))))
    assert back == cfg and isinstance(back.fft_conv1d_kernel_size, tuple)


def test_weights_in_jax_leaf_order(bundle_dir, jax_side):
    """The port writes the JAX package's flat layout: same key lists and
    the same array at every key."""
    m = jax_side["manifest"]
    with open(os.path.join(bundle_dir, "manifest.json")) as f:
        mine = json.load(f)
    assert mine["model_weight_keys"] == m["model_weight_keys"]
    assert mine["vocoder_weight_keys"] == m["vocoder_weight_keys"]
    with np.load(os.path.join(bundle_dir, "weights.npz")) as z:
        assert sorted(z.files) == sorted(jax_side["weights"])
        for k in z.files:
            np.testing.assert_array_equal(z[k], jax_side["weights"][k], err_msg=k)


def test_tree_leaves_follow_jax():
    """Keys sorted at every level, i.e. by the tuple of path parts, not
    by the joined 'a/b' string: the part 'a' sorts before 'a.b', but the
    string 'a.b' before 'a/b' ('.' < '/')."""
    tree = {"params": {"a": {"z": 1.0, "b": 2.0}, "a.b": 3.0, "a_b": {"c": 4.0}},
            "batch_stats": {"x": 5.0}}
    want = jax.tree.leaves(tree)
    assert [v for _, v in tree_leaves(tree)] == want == [5.0, 2.0, 1.0, 3.0, 4.0]
    joined = sorted((f"{'/'.join(p)}", v) for p, v in tree_leaves(tree))
    assert [v for _, v in joined] != want
    rebuilt = tree_from_leaves(tree, [np.float32(v) for v in want], "t")
    assert rebuilt["params"]["a"]["z"] == 1.0 and rebuilt["batch_stats"]["x"] == 5.0


def test_leaf_count_and_shapes_are_checked():
    tree = {"params": {"w": np.zeros((2, 3)), "b": np.zeros(3)}}
    with pytest.raises(ValueError, match="has 1 leaves, the model 2"):
        tree_from_leaves(tree, [np.zeros(3)], "model")
    with pytest.raises(ValueError, match="params/w"):
        tree_from_leaves(tree, [np.zeros(3), np.zeros((3, 2))], "model")


def test_weight_ordering_contract(tmp_path):
    """>= 1000 leaves come back in order (tests/test_export.py:135): the
    manifest's key lists, and the numeric-sort fallback of v1 bundles that
    have none, past 999 with the old 3-digit padding; a count that does not
    match the npz raises."""
    n = 1100
    keys = [f"m{i:05d}" for i in range(n)]
    vals = {k: np.full(1, i, np.float32) for i, k in enumerate(keys)}
    vals["v00000"] = np.zeros(1, np.float32)
    np.savez(tmp_path / "weights.npz", **vals)
    manifest = {"weights": "weights.npz", "model_weight_keys": keys,
                "vocoder_weight_keys": ["v00000"]}
    model, voc = load_flat_weights(str(tmp_path), manifest)
    np.testing.assert_array_equal(np.concatenate(model), np.arange(n, dtype=np.float32))
    assert len(voc) == 1
    with pytest.raises(ValueError, match="manifest lists"):
        load_flat_weights(str(tmp_path), {**manifest, "model_weight_keys": keys[:-1]})

    legacy = {f"m{i:03d}": np.full(1, i, np.float32) for i in range(n)}
    legacy["v000"] = np.zeros(1, np.float32)
    np.savez(tmp_path / "weights.npz", **legacy)
    model, _ = load_flat_weights(str(tmp_path), {"weights": "weights.npz"})
    np.testing.assert_array_equal(np.concatenate(model), np.arange(n, dtype=np.float32))


def test_bundle_matches_jax_bundle(bundle, jax_side):
    """The port's bundle on its own export against the JAX ServingBundle on
    the same weights, one request per sentence."""
    inputs, fe = jax_side["inputs"], _frontend()
    for ids, want in zip(inputs["ids"], jax_side["single"]):
        got = bundle.synthesize(ids, *_args(inputs), inputs["spk"])
        assert got["truncated"] is False
        _near_jax(got, want, fe, f"{len(ids)} phonemes")


def test_batch_chunks_and_pads_like_jax(bundle, jax_side):
    """3 rows on a bundle of batches (1, 2): a batch-2 group, then a
    batch-1 group (the JAX class's calls), row for row its results."""
    inputs = jax_side["inputs"]
    calls = []
    run = bundle._run
    bundle._run = lambda key, arrays: calls.append(list(key)) or run(key, arrays)
    try:
        got = bundle.synthesize_batch(inputs["ids"], *([a] * 3 for a in _args(inputs)),
                                      [inputs["spk"]] * 3)
    finally:
        del bundle._run
    assert calls == jax_side["calls"] == [[2, 32, 64], [1, 32, 64]]
    fe = _frontend()
    for i, (g, w) in enumerate(zip(got, jax_side["batch"])):
        assert g["truncated"] is w["truncated"] is False
        _near_jax(g, w, fe, f"row {i}")


def test_reads_jax_written_bundle(bundle, jax_side, tmp_path):
    """A bundle written by the JAX package (its programs ignored, the
    caller's config) gives the port's own export's bits."""
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump(jax_side["manifest"], f)
    np.savez(tmp_path / "weights.npz", **jax_side["weights"])
    assert jax_side["manifest"]["format"] == "styler_tpu.serving_bundle.v1"
    with pytest.raises(ValueError, match="holds no config"):
        ServingBundle(str(tmp_path), device="cpu")
    theirs = ServingBundle(str(tmp_path), default_config().replace(**SMALL), device="cpu")
    assert theirs.config.vocoder == "iSTFTNet" and theirs.mel_out == 64
    inputs = jax_side["inputs"]
    for ids in inputs["ids"][:2]:
        _assert_equal(theirs.synthesize(ids, *_args(inputs), inputs["spk"], d_control=1.2),
                      bundle.synthesize(ids, *_args(inputs), inputs["spk"], d_control=1.2))


def test_bundle_equals_live_synthesizer(bundle, synth, jax_side):
    """On the CPU the bundle's call is the live ``Synthesizer``'s forward:
    ``synthesize`` agrees bit for bit, controls included."""
    from styler_tpu_torch.synthesis import ReferenceFeatures

    inputs = jax_side["inputs"]
    ref = ReferenceFeatures(*_args(inputs), len(inputs["f0_norm"]))
    live = synth.synthesize(SENTENCES[1], ref, inputs["spk"], d_control=0.9, p_control=1.1)
    got = bundle.synthesize(synth.text_to_ids(SENTENCES[1]), *_args(inputs), inputs["spk"],
                            d_control=0.9, p_control=1.1)
    assert got["mel_len"] == live["mel_len"]
    for k in ("mel", "mel_noisy", "wav", "wav_noisy", "f0", "energy"):
        np.testing.assert_array_equal(got[k], live[k], err_msg=k)


def test_call_returns_the_program_outputs(bundle, jax_side):
    inputs = jax_side["inputs"]
    ids = inputs["ids"][0]
    src = np.zeros((1, 32), np.int32)
    src[0, : len(ids)] = ids
    mel = np.zeros((1, 64, 80), np.float32)
    f0, en = np.zeros((1, 64), np.float32), np.zeros((1, 64), np.float32)
    k = len(inputs["f0_norm"])
    mel[0, :k], f0[0, :k], en[0, :k] = _args(inputs)
    arrays = (src, np.array([len(ids)]), mel, f0, en, np.array([k]), inputs["spk"][None],
              1.0, 1.0, 1.0)
    out = bundle.call(1, 32, 64, *arrays)
    assert set(out) == {"mel_postnet", "mel_postnet_noisy", "wav", "wav_noisy", "mel_len", "f0",
                        "energy", "log_d"}
    assert out["wav"].shape == (1, 64 * 256) and out["mel_postnet"].shape == (1, 64, 80)
    assert out["log_d"].shape == (1, 32) and out["mel_len"].dtype == np.int32
    with pytest.raises(KeyError, match="fwd_b4_L32_M64"):
        bundle.call(4, 32, 64, *arrays)
    with pytest.raises(ValueError, match="mel"):
        bundle.call(1, 32, 64, src, arrays[1], mel[:, :32], *arrays[3:])


def test_tensor_controls_equal_float_controls(bundle):
    """The forward with the controls as 0-d float32 tensors (as a graph
    reads them) gives the float controls' bits."""
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.integers(1, 70, (1, 32)))
    mel = torch.from_numpy(rng.standard_normal((1, 64, 80)).astype(np.float32) - 4)
    f0, en = (torch.from_numpy(rng.random((1, 64)).astype(np.float32)) for _ in range(2))
    spk = torch.from_numpy(rng.standard_normal((1, 512)).astype(np.float32) / 22.6)
    lens = torch.tensor([32]), torch.tensor([64])
    args = (src, lens[0], mel, f0, en, lens[1], spk)
    ctrl = torch.tensor([1.3, 0.8, 1.1])
    a = bundle.synth._forward(*args, 1.3, 0.8, 1.1, 64)
    b = bundle.synth._forward(*args, ctrl[0], ctrl[1], ctrl[2], 64)
    for x, y in ((a[1], b[1]), (a[2], b[2]), (a[0].mel_postnet, b[0].mel_postnet),
                 (a[0].p_prediction, b[0].p_prediction), (a[0].mel_len, b[0].mel_len)):
        assert torch.equal(x, y)


def test_controls_change_output(bundle, jax_side):
    inputs = jax_side["inputs"]
    ids = inputs["ids"][0]
    fast = bundle.synthesize(ids, *_args(inputs), d_control=0.5)
    slow = bundle.synthesize(ids, *_args(inputs), d_control=1.5)
    assert fast["mel_len"] < slow["mel_len"]
    high = bundle.synthesize(ids, *_args(inputs), p_control=1.3)
    base = bundle.synthesize(ids, *_args(inputs))
    assert not np.array_equal(high["f0"], base["f0"])


def test_long_sentence_is_truncated_not_chunked(bundle, jax_side, caplog):
    inputs = jax_side["inputs"]
    ids = np.tile(inputs["ids"][1], 3)  # 57 phonemes > the 32 bucket
    with caplog.at_level(logging.WARNING, logger="styler_tpu_torch.export"):
        out = bundle.synthesize(ids, *_args(inputs), inputs["spk"])
    assert out["truncated"] is True and "chunks" not in out
    assert "largest exported src bucket 32; truncating" in caplog.text
    want = bundle.synthesize(ids[:32], *_args(inputs), inputs["spk"])
    np.testing.assert_array_equal(out["wav"], want["wav"])


def test_mel_out_follows_override(synth, tmp_path):
    """A mel bucket override larger than the config's raises the output
    cap with it."""
    manifest = save_serving_bundle(synth, str(tmp_path), mel_buckets=(128,))
    assert manifest["audio"]["mel_out"] == 128
    b = ServingBundle(str(tmp_path), device="cpu")
    assert b.mel_out == 128 and b.warmup() == 1
    rng = np.random.default_rng(4)
    out = b.synthesize(rng.integers(1, 70, 20), rng.standard_normal((100, 80)).astype(np.float32),
                       rng.random(100).astype(np.float32), rng.random(100).astype(np.float32))
    assert 0 < out["mel_len"] <= 128 and out["wav"].shape == (out["mel_len"] * 256,)


def test_int8_form_is_recorded(tmp_path, monkeypatch):
    """A HiFi-GAN bundle exported under STYLER_TPU_INT8_VOCODER=1 records
    the int8 form and is served in it, whatever the server's environment."""
    cfg = default_config().replace(**SMALL)
    monkeypatch.setenv("STYLER_TPU_INT8_VOCODER", "1")
    manifest = save_serving_bundle(load_synthesizer(cfg, vocoder_arch="HiFi-GAN", device="cpu"),
                                   str(tmp_path))
    assert manifest["vocoder"] == "HiFi-GAN" and manifest["vocoder_form"] == "int8"
    monkeypatch.setenv("STYLER_TPU_INT8_VOCODER", "0")
    b = ServingBundle(str(tmp_path), device="cpu")
    assert b.config.vocoder == "HiFi-GAN" and b.synth.int8_vocoder and b.synth.generator.quantize


def _write_ref(ref_dir, name, freq):
    t = np.arange(int(22050 * 0.6)) / 22050
    wav = (0.4 * np.sin(2 * np.pi * freq * t) * 32767).astype(np.int16)
    wavfile.write(str(ref_dir / f"{name}.wav"), 22050, wav)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("refs")
    _write_ref(d, "p001_001", 170)
    _write_ref(d, "p002_001", 120)
    return d


def test_bundle_synthesizer_under_the_server(bundle_dir, ref_dir, tmp_path):
    """``cli/serve.py:Server`` unchanged over ``BundleSynthesizer``: the
    reply contract of tests/test_torch_serve.py; a long sentence in a batch
    is truncated and said so."""
    cfg = default_config().replace(**SMALL, ref_audio_dir=str(ref_dir), ref_tg_dir=str(ref_dir))
    bs = BundleSynthesizer(bundle_dir, cfg, device="cpu")
    server = Server(bs, cfg, str(tmp_path / "out"))
    long = "The quick brown fox jumps over the lazy dog, " * 2
    replies = [server.handle(r) for r in (
        {"id": 0, "cmd": "ping"},
        {"id": 1, "sentence": "Hi.", "ref": "p001_001"},
        {"id": 2, "sentence": "Hi.", "ref": "missing"},
        {"id": 3, "sentences": ["One.", "Two.", long], "refs": ["p001_001", "p002_001", "p001_001"],
         "d_control": 1.2},
        {"id": 4, "cmd": "shutdown"},
    )]
    assert replies[0]["pong"] and replies[4]["bye"]
    assert replies[1]["ok"] and set(replies[1]) == {"id", "ok", "wav", "wav_noisy", "mel_len", "ms"}
    assert not replies[2]["ok"] and "FileNotFoundError" in replies[2]["error"]
    r = replies[3]
    assert r["ok"] and r["truncated"] == [False, False, True] and len(r["wavs"]) == 3
    for path, ml in zip([replies[1]["wav"], *r["wavs"]], [replies[1]["mel_len"], *r["mel_lens"]]):
        sr, data = wavfile.read(path)
        assert sr == 22050 and len(data) == ml * 256 > 0


def test_export_cli_in_process(tmp_path, capsys):
    out = tmp_path / "b"
    assert export_cli.main(["--device", "cpu", "--out", str(out), "--src_buckets", "32",
                            "--mel_buckets", "64", "--batch", "1", "2", "--fused"]) == 0
    assert "exported 2 entries (iSTFTNet, bf16)" in capsys.readouterr().out
    b = ServingBundle(str(out), device="cpu")
    assert sorted(b._entries) == [(1, 32, 64), (2, 32, 64)] and b.warmup() == 2


def test_export_cli_refuses_platforms(capsys):
    with pytest.raises(SystemExit):
        export_cli.main(["--device", "cpu", "--out", "x", "--platforms", "tpu", "cpu"])
    assert "--platforms names XLA lowering targets" in capsys.readouterr().err


def test_serve_cli_bundle_child_process(bundle_dir, ref_dir, tmp_path):
    """``python -m styler_tpu_torch.cli.serve --bundle DIR --warmup`` as a
    child process: every stdout line a JSON reply."""
    reqs = [{"id": 1, "sentence": "Hi.", "ref": "p001_001"}, {"id": 2, "cmd": "shutdown"}]
    proc = subprocess.run(
        [sys.executable, "-m", "styler_tpu_torch.cli.serve", "--device", "cpu", "--bundle",
         bundle_dir, "--warmup", "--ref_audio_dir", str(ref_dir), "--ref_tg_dir", str(ref_dir),
         "--outdir", str(tmp_path / "out"), "--src_buckets", "32", "--mel_buckets", "64"],
        input="".join(json.dumps(r) + "\n" for r in reqs), capture_output=True, text=True,
        cwd=REPO, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    replies = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["id"] for r in replies] == [1, 2] and replies[0]["ok"], replies
    assert "warmup: 2 forwards" in proc.stderr
    sr, data = wavfile.read(replies[0]["wav"])
    assert len(data) == replies[0]["mel_len"] * 256
