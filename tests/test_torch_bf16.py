"""The bfloat16 acoustic model (``Config.compute_dtype = "bfloat16"``) on
the CPU, against the JAX package's mixed precision, on the committed
trained asset at src 32, mel 64, one request: ``SENTENCES[1]`` of
tests/test_torch_synthesis.py on its validation-wav reference.

How close: the JAX package on the CPU lets XLA keep excess precision (a
bfloat16 product feeding a norm in the same fusion is not rounded), while
the port rounds at every ``dtype=`` site as flax's semantics say. So the
port is held to a distance, not to equality: for each output, the mean
absolute difference between the port's bf16 and the JAX package's bf16
must lie within twice the JAX package's own bf16-vs-f32 distance on the
same input, plus a floor of half a bfloat16 step (2^-9) of the output's
mean magnitude, the most that one rounding of the output to bfloat16 moves
it. Both numbers are printed in the message.

- the eval forward, teacher-forced with the JAX f32 request's rounded
  durations and its pitch and energy as targets, so no rounding edge can
  move the lengths or the embedding bins: log-durations, pitch, energy and
  the four mels;
- ``Synthesizer.synthesize``: the log-durations as above, each rounded
  duration equal unless the two continuous values straddle a rounding edge
  within bfloat16 noise of it (the rule the batch tests keep for discrete
  steps), and, where
  the durations agree, pitch, energy and the mel;
- a dtype probe: forward hooks on every ``nn.Conv1d`` / ``nn.Linear`` of the
  model record the dtype each computed in; the bf16 ones must be exactly
  the JAX package's ``dtype=`` sites, and kernel B's gates and weights
  float32;
- ``cli.synthesize --bf16`` and ``cli.serve --bf16`` on ``--device cpu``; a
  serving bundle of a bf16 Synthesizer records and replays the dtype;
  training with a bf16 config raises, naming Queue 1 [12].
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp

from styler_tpu.core.checkpoint import load_acoustic_npz as j_load
from styler_tpu.core.config import default_config as j_config
from styler_tpu.models import STYLER as JSTYLER
from styler_tpu.synthesis import load_synthesizer as j_load_synthesizer
from styler_tpu_torch.cli import synthesize
from styler_tpu_torch.core.checkpoint import default_acoustic_asset, load_acoustic_npz
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.core.convert import load_flax_tree
from styler_tpu_torch.models import STYLER
from styler_tpu_torch.synthesis import load_synthesizer
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)
from tests.test_torch_serve import REPO, _wav_len, _write_ref
from tests.test_torch_synthesis import (  # noqa: F401 (fixtures)
    SENTENCES,
    SMALL,
    _jax_ref,
    _np_out,
    _spk,
    jgold,
    jref,
)

L, M = SMALL["src_buckets"][0], SMALL["mel_buckets"][0]
SENTENCE = SENTENCES[1]
BF16_STEP = 2.0 ** -8  # bfloat16's relative spacing: 8 significant bits
FORWARD_KEYS = ("log_d_prediction", "p_prediction", "e_prediction", "mel", "mel_postnet",
                "mel_noisy", "mel_postnet_noisy")
#: the JAX model's dtype= sites (styler_tpu/models/transformer.py:48-50,66,84,89,225-228,
#: audio_encoder.py:93, predictors.py:35-38)
BF16_SITES = re.compile(
    r"(style_modeling\.text_encoder|decoder)\.layer_\d+\.(slf_attn\.(w_qs|w_ks|w_vs|fc)"
    r"|pos_ffn\.w_[12])"
    r"|style_modeling\.audio_encoder\.convs_[dper]\.conv_\d"
    r"|style_modeling\.(duration|pitch|energy)_predictor\.conv1d_[12]"
    r"|postnet\.conv_\d")


def _inputs(jgold, jref):
    """One request as teacher-forced eval-forward inputs: the sentence's
    ids, the reference, and the JAX f32 request's rounded durations, pitch
    and energy as targets."""
    from styler_tpu_torch.textproc import G2p, text_to_sequence, to_phoneme_string

    ids = text_to_sequence(to_phoneme_string(SENTENCE, G2p()), ["english_cleaners"])
    j = jgold["outputs"][SENTENCE]
    src = np.zeros((1, L), np.int64)
    src[0, : len(ids)] = ids
    d = np.clip(np.round(np.exp(np.asarray(j["duration"], np.float64)) - 1.0), 0, None)
    d[len(ids):] = 0
    ml = j["mel_len"]
    pad = lambda a: np.pad(np.asarray(a, np.float32), (0, M - len(a)))[None]  # noqa: E731
    return {"src_seq": src, "mel_target": jref.mel[None], "p_norm": jref.f0_norm[None],
            "e_input": jref.energy01[None], "src_len": np.array([len(ids)]),
            "mel_len": np.array([jref.mel_len]), "speaker_embed": _spk()[None],
            "d_target": d[None].astype(np.int64), "p_target": pad(j["f0"][:ml]),
            "e_target": pad(j["energy"][:ml])}


def _jax_forward(inp, dtype):
    params, stats = j_load(default_acoustic_asset())
    model = JSTYLER(j_config().replace(**SMALL, compute_dtype=dtype))
    a = {k: jnp.asarray(v, jnp.int32 if v.dtype.kind == "i" else jnp.float32)
         for k, v in inp.items()}
    out = jax.jit(lambda v, a: model.apply(
        v, src_seq=a["src_seq"], mel_target=a["mel_target"], mel_aug=a["mel_target"],
        p_norm=a["p_norm"], e_input=a["e_input"], src_len=a["src_len"], mel_len=a["mel_len"],
        max_src_len=L, max_mel_len=M, speaker_embed=a["speaker_embed"], d_target=a["d_target"],
        p_target=a["p_target"], e_target=a["e_target"],
    ))({"params": params, "batch_stats": stats}, a)
    return {k: np.asarray(getattr(out, k)).astype(np.float32) for k in FORWARD_KEYS}


def _port_model(dtype):
    model = STYLER(default_config().replace(**SMALL, compute_dtype=dtype))
    load_flax_tree(model, *load_acoustic_npz(default_acoustic_asset()))
    return model.eval()


def _port_forward(model, inp):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in inp.items()}
    with torch.no_grad():
        out = model(t["src_seq"], t["mel_target"], t["mel_target"], t["p_norm"], t["e_input"],
                    t["src_len"], t["mel_len"], M, t["speaker_embed"], d_target=t["d_target"],
                    p_target=t["p_target"], e_target=t["e_target"])
    return {k: getattr(out, k).float().numpy() for k in FORWARD_KEYS}


@pytest.fixture(scope="module")
def forward(jgold, jref, tmp_path_factory):
    inp = _inputs(jgold, jref)
    jax_out = golden(tmp_path_factory, "bf16_forward",
                     lambda: {dt: _jax_forward(inp, dt) for dt in ("float32", "bfloat16")})
    return jax_out, _port_forward(_port_model("bfloat16"), inp)


def _hold(what, port, jax_bf16, jax_f32):
    """The port's bf16 ``port`` against the JAX package's ``jax_bf16``:
    mean |difference| within 2 x mean |jax_bf16 - jax_f32| + 2^-9 x mean
    |jax_f32|."""
    port, jb, jf = (np.asarray(x, np.float64) for x in (port, jax_bf16, jax_f32))
    assert port.shape == jb.shape == jf.shape, what
    d_port, d_jax = np.abs(port - jb).mean(), np.abs(jb - jf).mean()
    floor = BF16_STEP / 2 * np.abs(jf).mean()
    msg = (f"{what}: port bf16 vs JAX bf16 {d_port:.6g}; JAX bf16 vs f32 {d_jax:.6g}; "
           f"bound 2 x {d_jax:.6g} + {floor:.6g}")
    print(msg)
    assert np.isfinite(port).all() and d_port <= 2 * d_jax + floor, msg


@pytest.mark.parametrize("key", FORWARD_KEYS)
def test_eval_forward_against_jax(forward, key):
    jax_out, port = forward
    _hold(key, port[key], jax_out["bfloat16"][key], jax_out["float32"][key])


@pytest.fixture(scope="module")
def synthesized(jgold, jref, tmp_path_factory):
    def compute():
        jsynth = j_load_synthesizer(j_config().replace(**SMALL, compute_dtype="bfloat16"))
        return _np_out(jsynth.synthesize(SENTENCE, _jax_ref(jsynth), _spk()))

    jb = golden(tmp_path_factory, "bf16_synthesize", compute)
    synth = load_synthesizer(default_config().replace(**SMALL, compute_dtype="bfloat16"),
                             device="cpu")
    return jgold["outputs"][SENTENCE], jb, synth.synthesize(SENTENCE, jref, _spk())


def test_synthesize_against_jax(synthesized):
    jf, jb, t = synthesized
    n = int((~np.asarray(t["src_mask"][0])).sum())
    ld = [np.asarray(x["duration"], np.float64)[:n] for x in (t, jb, jf)]
    _hold("log_d", *ld)
    # a rounded duration may differ only where the two continuous values
    # straddle an edge of round(exp(ld) - 1) within bf16 noise of it
    raw_t, raw_j = np.exp(ld[0]) - 1.0, np.exp(ld[1]) - 1.0
    flips = np.nonzero(np.round(raw_t) != np.round(raw_j))[0]
    noise = 4 * BF16_STEP * np.maximum(np.abs(raw_j), 1.0)
    for i in flips:
        edge = np.floor(max(raw_t[i], raw_j[i])) + 0.5
        assert abs(raw_t[i] - edge) <= noise[i] and abs(raw_j[i] - edge) <= noise[i], (
            f"phoneme {i}: rounded duration {np.round(raw_t[i])} vs JAX bf16 "
            f"{np.round(raw_j[i])}, continuous {raw_t[i]} vs {raw_j[i]}")
    print(f"rounded-duration flips: {len(flips)} of {n}")
    if len(flips) == 0:
        assert t["mel_len"] == jb["mel_len"] == jf["mel_len"]
        for key in ("f0", "energy", "mel", "mel_noisy"):
            _hold(key, t[key], jb[key], jf[key])


def test_dtype_probe(monkeypatch, jgold, jref):
    """Which layers computed in bfloat16, and kernel B's operand dtypes."""
    import styler_tpu_torch.ops.lstm as lstm_mod

    model = _port_model("bfloat16")
    seen, lstm_calls = {}, []
    def record(name):
        def hook(module, args, out):
            seen.setdefault(name, out.dtype)
        return hook

    hooks = [m.register_forward_hook(record(name))
             for name, m in model.named_modules() if isinstance(m, (tnn.Conv1d, tnn.Linear))]
    real = lstm_mod.lstm_recurrence

    def spy(gates, w_t, *a, **kw):
        lstm_calls.append((gates.dtype, w_t.dtype))
        return real(gates, w_t, *a, **kw)

    monkeypatch.setattr(lstm_mod, "lstm_recurrence", spy)
    _port_forward(model, _inputs(jgold, jref))
    for h in hooks:
        h.remove()
    layers = {name for name, m in model.named_modules() if isinstance(m, (tnn.Conv1d, tnn.Linear))}
    # the eval forward runs every layer but the DAT classifiers' second pass
    assert set(seen) == layers
    bf16 = {name for name, dt in seen.items() if dt == torch.bfloat16}
    assert bf16 == {name for name in layers if BF16_SITES.fullmatch(name)}
    assert len(bf16) == 2 * 6 + 4 * 6 + 4 * 3 + 3 * 2 + 5
    assert {dt for name, dt in seen.items() if name not in bf16} == {torch.float32}
    assert lstm_calls and set(lstm_calls) == {(torch.float32, torch.float32)}


def test_float32_mode_has_no_bfloat16():
    model = _port_model("float32")
    assert all(m.compute_dtype == torch.float32 for m in model.modules() if hasattr(m, "compute_dtype"))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.dtype == torch.float32 for p in _port_model("bfloat16").parameters())


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("refs")
    _write_ref(d, "p001_001", 170)
    return d


def test_synthesize_cli_bf16(ref_dir, tmp_path, monkeypatch):
    import styler_tpu_torch.synthesis as synthesis

    loaded = []
    real = synthesis.load_synthesizer
    monkeypatch.setattr(synthesis, "load_synthesizer",
                        lambda *a, **kw: loaded.append(real(*a, **kw)) or loaded[-1])
    monkeypatch.chdir(tmp_path)
    outdir = tmp_path / "out"
    synthesize.main(["--device", "cpu", "--bf16", "--src_buckets", "32", "--mel_buckets", "64",
                     "--ref_name", "p001_001", "--ref_audio_dir", str(ref_dir), "--ref_tg_dir",
                     str(ref_dir), "--sentence", "Hi.", "--outdir", str(outdir)])
    (synth,) = loaded
    assert synth.config.compute_dtype == "bfloat16"
    assert synth.model.decoder.layer_0.slf_attn.w_qs.compute_dtype == torch.bfloat16
    stem = "0_iSTFTNet_Hi."
    assert set(os.listdir(outdir)) == {stem + ".wav", stem + "_noisy.wav", stem + "_mel.npy"}
    m = np.load(outdir / (stem + "_mel.npy"))
    assert m.ndim == 2 and m.shape[1] == 80 and np.isfinite(m).all()
    assert _wav_len(outdir / (stem + ".wav")) == m.shape[0] * 256


def test_serve_cli_bf16(ref_dir, tmp_path):
    """``python -m styler_tpu_torch.cli.serve --device cpu --bf16``: one
    request and shutdown, JSON replies only on stdout."""
    reqs = [{"id": 1, "sentence": "Hi.", "ref": "p001_001"}, {"id": 2, "cmd": "shutdown"}]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": str(torch.get_num_threads())}
    proc = subprocess.run(
        [sys.executable, "-m", "styler_tpu_torch.cli.serve", "--device", "cpu", "--bf16",
         "--ref_audio_dir", str(ref_dir), "--ref_tg_dir", str(ref_dir), "--outdir",
         str(tmp_path / "out"), "--src_buckets", "32", "--mel_buckets", "64"],
        input="".join(json.dumps(r) + "\n" for r in reqs), capture_output=True, text=True,
        cwd=str(tmp_path), env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [line["id"] for line in lines] == [1, 2] and lines[0]["ok"] and lines[1]["bye"], lines
    assert _wav_len(os.path.join(tmp_path, lines[0]["wav"])) == lines[0]["mel_len"] * 256 > 0


def test_bundle_records_and_replays_bf16(jref, tmp_path):
    """A bundle of a bf16 Synthesizer carries compute_dtype in its Config
    JSON; ``ServingBundle`` rebuilds the bf16 model from it and a request
    equals the bf16 Synthesizer's (on the CPU: the eager forward)."""
    from styler_tpu_torch.core.export import BundleSynthesizer, save_serving_bundle

    cfg = default_config().replace(**SMALL, compute_dtype="bfloat16")
    synth = load_synthesizer(cfg, device="cpu")
    manifest = save_serving_bundle(synth, str(tmp_path / "b"))
    assert manifest["config"]["compute_dtype"] == "bfloat16"
    bs = BundleSynthesizer(str(tmp_path / "b"), default_config().replace(**SMALL), device="cpu")
    assert bs.bundle.config.compute_dtype == "bfloat16"
    got = bs.synthesize("Hi.", jref, _spk())
    want = synth.synthesize("Hi.", jref, _spk())
    assert got["mel_len"] == want["mel_len"] > 0
    for key in ("mel", "f0", "energy"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("make", ["fresh", "asset"])
def test_bf16_training_raises(make):
    from styler_tpu_torch.train import create_train_state, train_state_from_flax

    cfg = default_config().replace(compute_dtype="bfloat16")
    with pytest.raises(NotImplementedError, match=r"Queue 1 \[12\]"):
        if make == "fresh":
            create_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        else:
            train_state_from_flax(cfg, *load_acoustic_npz(default_acoustic_asset()), device="cpu")
