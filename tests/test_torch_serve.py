"""The port's entry points on the CPU: the JSON-lines server
(``styler_tpu_torch/cli/serve.py``) and the synthesize CLI
(``styler_tpu_torch/cli/synthesize.py``), with the reply contract and the
file inventory of the JAX package's ``cli/serve.py`` and
``cli/synthesize.py`` (``tests/test_cli.py:78-112, 188-260``), at src bucket
32 and mel bucket 64, ``--device cpu``.

The handler runs in-process; one test starts the server as a child
process and reads its stdout, which must hold only JSON replies.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from styler_tpu_torch.cli import export, serve, synthesize
from styler_tpu_torch.cli.serve import CONTRACT, Server, warmup_batch_sizes
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.synthesis import load_synthesizer
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--src_buckets", "32", "--mel_buckets", "64"]


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


# the request list of tests/test_cli.py:203-222
REQUESTS = [
    {"id": 0, "cmd": "ping"},
    {"id": 1, "sentence": "Hi.", "ref": "p001_001"},
    {"id": 2, "sentence": "Hi again.", "ref": "missing_ref"},
    {"id": 3, "sentence": "Hi.", "ref": "p001_001", "out": "custom.flac"},
    {"id": 5, "sentences": ["One two.", "Three."], "ref": "p001_001"},
    {"id": 6, "sentences": [], "ref": "p001_001"},
    {"id": 7, "sentences": ["Hi."], "refs": [], "ref": "p001_001"},
    {"id": 8, "ref": "p001_001", "sentence": "The quick brown fox jumps over the lazy dog, " * 4},
    {"id": 9, "ref": "p001_001"},
    {"id": 4, "cmd": "shutdown"},
]
# beyond that list: two malformed controls, which are request errors that
# leave the handler serving; then three sentences over two noisy
# references, padded to 4 rows and cut back, the last one truncated to the
# src bucket
EXTRA = [
    {"id": 11, "sentence": "Hi.", "ref": "p001_001", "d_control": "x"},
    {"id": 12, "sentence": "Hi.", "ref": "p001_001", "d_control": None},
    {"id": 10, "sentences": ["One.", "Two.", "The quick brown fox jumps over the lazy dog, " * 4],
     "refs": ["p001_001", "p002_001", "p001_001"], "noisy_input": True, "d_control": 1.2},
]


def _serve_all(ref_dir, outdir):
    """Every request through one in-process handler; the replies, the
    reference cache's keys, the file counter and the files written."""
    cfg = default_config().replace(src_buckets=(32,), mel_buckets=(64,),
                                   ref_audio_dir=str(ref_dir), ref_tg_dir=str(ref_dir))
    server = Server(load_synthesizer(cfg, device="cpu"), cfg, str(outdir))
    replies = {}
    for req in REQUESTS + EXTRA:
        if req.get("out"):
            req = {**req, "out": str(outdir / req["out"])}
        replies[str(req["id"])] = json.loads(json.dumps(server.handle(req)))  # JSON replies
    return {"replies": replies, "cache": sorted(list(k) for k in server.ref_cache),
            "n": server.n, "files": sorted(os.listdir(outdir))}


@pytest.fixture(scope="module")
def served(ref_dir, tmp_path_factory):
    """Computed once per session across xdist workers (the replies name
    files in the session's temporary directory, which every worker reads)."""
    got = golden(tmp_path_factory, "serve_replies",
                 lambda: _serve_all(ref_dir, tmp_path_factory.mktemp("out")))
    return got, {int(k): v for k, v in got["replies"].items()}


def _wav_len(path):
    sr, data = wavfile.read(path)
    assert sr == 22050 and data.dtype == np.int16
    return len(data)


def test_ping_and_shutdown(served):
    _, r = served
    assert r[0] == {"id": 0, "ok": True, "pong": True}
    assert r[4] == {"id": 4, "ok": True, "bye": True}


def test_single_request(served):
    _, r = served
    assert r[1]["ok"], r[1]
    assert set(r[1]) == {"id", "ok", "wav", "wav_noisy", "mel_len", "ms"}
    assert _wav_len(r[1]["wav"]) == r[1]["mel_len"] * 256 > 0
    assert _wav_len(r[1]["wav_noisy"]) == r[1]["mel_len"] * 256


def test_missing_reference_is_a_request_error(served):
    _, r = served
    assert not r[2]["ok"] and "FileNotFoundError" in r[2]["error"]


def test_out_path_is_made_wav(served):
    _, r = served
    assert r[3]["ok"], r[3]
    assert r[3]["wav"].endswith("custom.flac.wav")
    assert r[3]["wav_noisy"].endswith("custom.flac_noisy.wav")
    assert os.path.exists(r[3]["wav"]) and os.path.exists(r[3]["wav_noisy"])


def test_batch_request(served):
    _, r = served
    assert r[5]["ok"], r[5]
    assert len(r[5]["wavs"]) == len(r[5]["wavs_noisy"]) == len(r[5]["mel_lens"]) == 2
    assert "truncated" not in r[5]
    for w, wn, ml in zip(r[5]["wavs"], r[5]["wavs_noisy"], r[5]["mel_lens"]):
        assert _wav_len(w) == _wav_len(wn) == ml * 256 > 0


@pytest.mark.parametrize("rid,words", [(6, "empty"), (7, "must match")])
def test_bad_batches_are_request_errors(served, rid, words):
    _, r = served
    assert not r[rid]["ok"] and words in r[rid]["error"]


def test_long_sentence_is_chunked(served):
    _, r = served
    assert r[8]["ok"], r[8]
    assert _wav_len(r[8]["wav"]) == r[8]["mel_len"] * 256 > 0


def test_unknown_shape_gets_the_contract(served):
    _, r = served
    assert r[9] == {"id": 9, "ok": False, "error": CONTRACT} and "sentence" in CONTRACT


@pytest.mark.parametrize("rid,error", [(11, "ValueError"), (12, "TypeError")])
def test_malformed_control_is_a_request_error(served, rid, error):
    _, r = served
    assert not r[rid]["ok"] and r[rid]["error"].startswith(error), r[rid]
    assert r[10]["ok"]  # the request after them is answered


def test_padded_batch_is_cut_back_and_truncation_reported(served):
    _, r = served
    assert r[10]["ok"], r[10]
    assert len(r[10]["wavs"]) == len(r[10]["mel_lens"]) == 3
    assert r[10]["truncated"] == [False, False, True]
    for w, ml in zip(r[10]["wavs"], r[10]["mel_lens"]):
        assert _wav_len(w) == ml * 256 > 0


def test_reference_cache_and_counter(served):
    got, _ = served
    assert got["cache"] == [["p001_001", None, False], ["p001_001", None, True],
                            ["p002_001", None, True]]
    # one file pair per synthesized row: 1 + 1 + 2 + 1 + 3
    assert got["n"] == 8
    assert len([f for f in got["files"] if f.endswith(".wav")]) == 2 * 8


def test_warmup_batch_sizes():
    assert warmup_batch_sizes(1) == (1,)
    assert warmup_batch_sizes(5) == (1, 2, 4, 8)
    assert warmup_batch_sizes(8) == (1, 2, 4, 8)


def test_server_child_process(ref_dir, tmp_path):
    """``python -m styler_tpu_torch.cli.serve --device cpu``: ping, a
    request with a malformed control, one request, shutdown; exit code 0
    and only JSON replies on stdout."""
    reqs = [{"id": 0, "cmd": "ping"},
            {"id": 1, "sentence": "Hi.", "ref": "p001_001", "d_control": "fast"},
            {"id": 2, "sentence": "Hi.", "ref": "p001_001"},
            {"id": 3, "cmd": "shutdown"}]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": str(torch.get_num_threads())}
    proc = subprocess.run(
        [sys.executable, "-m", "styler_tpu_torch.cli.serve", "--device", "cpu",
         "--ref_audio_dir", str(ref_dir), "--ref_tg_dir", str(ref_dir),
         "--outdir", str(tmp_path / "out"), *SMALL],
        input="".join(json.dumps(r) + "\n" for r in reqs), capture_output=True, text=True,
        cwd=str(tmp_path), env=env, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [line["id"] for line in lines] == [0, 1, 2, 3], proc.stdout
    assert lines[0]["pong"] and lines[3]["bye"] and lines[2]["ok"], lines
    assert not lines[1]["ok"] and lines[1]["error"].startswith("ValueError"), lines[1]
    assert _wav_len(os.path.join(tmp_path, lines[2]["wav"])) == lines[2]["mel_len"] * 256 > 0
    assert "speaker embedder" in proc.stderr  # logs go to stderr


def _run_synthesize(monkeypatch, tmp_path, *argv):
    monkeypatch.chdir(tmp_path)
    synthesize.main(["--device", "cpu", *SMALL, *argv])


def test_synthesize_cli(ref_dir, tmp_path, monkeypatch):
    outdir = tmp_path / "out"
    _run_synthesize(monkeypatch, tmp_path, "--ref_name", "p001_001", "--ref_audio_dir", str(ref_dir),
                    "--ref_tg_dir", str(ref_dir), "--sentence", "Hi.", "--outdir", str(outdir))
    files = set(os.listdir(outdir))
    stem = "0_iSTFTNet_Hi."
    assert files == {stem + ".wav", stem + "_noisy.wav", stem + "_mel.npy"}
    m = np.load(outdir / (stem + "_mel.npy"))
    assert m.ndim == 2 and m.shape[1] == 80 and np.isfinite(m).all()
    assert _wav_len(outdir / (stem + ".wav")) == _wav_len(outdir / (stem + "_noisy.wav")) \
        == m.shape[0] * 256


class FakeSynth:
    """Stands in for the Synthesizer in the tests of the CLI's other modes,
    which check what the CLI asks for and writes: the methods themselves
    are held to the JAX package elsewhere (test_torch_batch.py,
    test_torch_mix.py), and 32 mix-and-match rows through the bf16
    vocoder are slow on a CPU. Records each call with its controls."""

    def __init__(self, config, *args, device=None, **kw):
        from styler_tpu_torch.dsp.mel import MelFrontend

        self.config = config.replace(vocoder="iSTFTNet")
        self.frontend = MelFrontend(config, device)
        self.calls = []
        FakeSynth.last = self

    @staticmethod
    def _row(n):
        rng = np.random.default_rng(n)
        return {"mel": rng.standard_normal((n, 80)).astype(np.float32),
                "mel_noisy": rng.standard_normal((n, 80)).astype(np.float32),
                "wav": 0.1 * rng.standard_normal(n * 256).astype(np.float32),
                "wav_noisy": 0.1 * rng.standard_normal(n * 256).astype(np.float32),
                "f0": np.zeros(n, np.float32), "energy": np.zeros(n, np.float32), "mel_len": n}

    def synthesize(self, sentence, ref, spk, d_control=1.0, p_control=1.0, e_control=1.0):
        self.calls.append(("synthesize", sentence, (d_control, p_control, e_control)))
        return self._row(5)

    def synthesize_batch(self, sentences, refs, spks, mesh=None, d_control=1.0, p_control=1.0,
                         e_control=1.0):
        assert mesh is None and len(refs) == len(spks) == len(sentences)
        self.calls.append(("synthesize_batch", tuple(sentences), (d_control, p_control, e_control)))
        return [self._row(3 + i) for i in range(len(sentences))]

    def inspect(self, sentence, ref, spk):
        self.calls.append(("inspect", sentence))
        return {t: self._row(4) for t in ("T+D+P+E+S+N", "T+D+P+E+N", "T+D+P+N", "T+D+N", "T+N",
                                          "T", "T+D", "T+D+P", "T+D+P+E", "T+D+P+E+S")}

    def mix_and_match(self, sentence_by_ref, refs, spks):
        self.calls.append(("mix_and_match", tuple(sentence_by_ref)))
        return {f"{c:05b}": self._row(2) for c in range(32)}


@pytest.fixture
def fake(monkeypatch):
    import styler_tpu_torch.synthesis

    monkeypatch.setattr(styler_tpu_torch.synthesis, "load_synthesizer", FakeSynth)
    return FakeSynth


def test_synthesize_cli_inspection(ref_dir, tmp_path, monkeypatch, fake):
    outdir = tmp_path / "out"
    _run_synthesize(monkeypatch, tmp_path, "--ref_name", "p001_001", "--ref_audio_dir", str(ref_dir),
                    "--ref_tg_dir", str(ref_dir), "--sentence", "Hi.", "--outdir", str(outdir),
                    "--inspection", "--duration_control", "0.8", "--energy_control", "1.1")
    assert fake.last.calls == [("synthesize", "Hi.", (0.8, 1.0, 1.1)), ("inspect", "Hi.")]
    files = set(os.listdir(outdir))
    inspect = {f for f in files if "_inspect_" in f}
    assert len(inspect) == 10 and all(f.endswith(".wav") for f in inspect)
    assert "0_iSTFTNet_Hi._inspect_TDPESN.wav" in inspect and "0_iSTFTNet_Hi._inspect_T.wav" in inspect
    assert len(files) == 13 and not [f for f in files if f.endswith(".png")]


def test_synthesize_cli_cont(ref_dir, tmp_path, monkeypatch, fake):
    outdir = tmp_path / "out"
    _run_synthesize(monkeypatch, tmp_path, "--cont", "--r1", "p001_001", "--r2", "p002_001",
                    "--ref_audio_dir", str(ref_dir), "--ref_tg_dir", str(ref_dir),
                    "--outdir", str(outdir))
    from styler_tpu_torch.data.sentences import sentences

    assert fake.last.calls == [("mix_and_match", (sentences[0], sentences[1]))]
    cont = outdir / "control_r1_p001_001_r2_p002_001"
    files = set(os.listdir(cont))
    assert files == {"p001_001.wav", "p002_001.wav"} | {
        f"{c:05b}{ext}" for c in range(32) for ext in (".wav", ".npy")}
    with open(cont / "p002_001.wav", "rb") as a, open(ref_dir / "p002_001.wav", "rb") as b:
        assert a.read() == b.read()
    assert np.load(cont / "10110.npy").shape == (2, 80)
    assert _wav_len(cont / "10110.wav") == 2 * 256


def test_synthesize_cli_batch(ref_dir, tmp_path, monkeypatch, fake):
    outdir = tmp_path / "out"
    _run_synthesize(monkeypatch, tmp_path, "--ref_name", "p002_001", "--ref_audio_dir", str(ref_dir),
                    "--ref_tg_dir", str(ref_dir), "--batch", "--outdir", str(outdir),
                    "--pitch_control", "1.2")
    from styler_tpu_torch.data.sentences import sentences

    assert fake.last.calls == [("synthesize_batch", tuple(sentences), (1.0, 1.2, 1.0))]
    files = set(os.listdir(outdir))
    assert len(files) == 3 * len(sentences)
    for i, s in enumerate(sentences):
        stem = f"{i}_iSTFTNet_{s[:10].replace(' ', '_')}"
        assert np.load(outdir / (stem + "_mel.npy")).shape == (3 + i, 80)
        assert _wav_len(outdir / (stem + "_noisy.wav")) == (3 + i) * 256


@pytest.mark.parametrize("cli,argv,item", [
    (synthesize, ["--ref_name", "x", "--bf16"], r"Queue 1 \[9\]"),
    (synthesize, ["--ref_name", "x", "--vocoder", "MelGAN"], r"Queue 1 \[15\]"),
    (synthesize, ["--ref_name", "x", "--vocoder", "WaveGlow"], r"Queue 1 \[15\]"),
    (synthesize, ["--ref_name", "x", "--ckpt", "checkpoint_560000.pth.tar"], r"Queue 1 \[9\]"),
    (serve, ["--bf16"], r"Queue 1 \[9\]"),
    (export, ["--out", "bundle/", "--vocoder", "MelGAN"], r"Queue 1 \[15\]"),
    (serve, ["--vocoder", "MelGAN"], r"Queue 1 \[15\]"),
])
def test_unported_flags_raise(cli, argv, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["--device", "cpu", *argv])


@pytest.mark.parametrize("cli,argv", [(synthesize, ["--ref_name", "x"]), (serve, [])])
def test_no_silent_cpu_fallback(cli, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if cli is serve:  # main points stdout at stderr before it loads
        monkeypatch.setattr(os, "dup2", lambda *a: None)
        monkeypatch.setattr(sys, "stdout", sys.stdout)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)


def test_synthesize_needs_a_reference(capsys):
    with pytest.raises(SystemExit):
        synthesize.main(["--device", "cpu", "--cont", "--r1", "a"])
    assert "need --ref_name" in capsys.readouterr().err
