"""Persistent synthesis server of the port (JSON lines over stdin/stdout;
counterpart of ``cli/serve.py``).

The model and vocoder stay on the card in one process; reference features
and speaker embeddings are cached per (name, speaker_id, noisy_input).

Protocol: one JSON object per line on stdin, one reply per line on stdout
(stderr carries logs):

  {"sentence": "...", "ref": "p225_001",          # required
   "id": any,                                      # echoed back
   "speaker_id": "p225",                           # optional
   "noisy_input": false,                           # optional
   "d_control": 1.0, "p_control": 1.0, "e_control": 1.0,
   "out": "custom/path.wav"}                       # optional; made .wav

  -> {"id":..., "ok": true, "wav": ".../x.wav", "wav_noisy": "...",
      "mel_len": N, "ms": 12.3}
  -> {"id":..., "ok": false, "error": "..."}

A batch runs N sentences through one ``synthesize_batch`` call, padded to
the next power of two and cut back:

  {"sentences": ["...", "..."], "ref": "p225_001",  # or per-sentence
   "refs": ["p225_001", "p226_002"], ...}           # "refs" list
  -> {"id":..., "ok": true, "wavs": [...], "wavs_noisy": [...],
      "mel_lens": [...], "ms": ...,
      "truncated": [...]}   # present iff some item was clamped to the
                            # largest bucket

{"cmd": "ping"} replies {"ok": true, "pong": true}; {"cmd": "shutdown"}
exits after replying. EOF on stdin also exits.

Usage:
  python -m styler_tpu_torch.cli.serve --ref_audio_dir refs/ \\
      --ref_tg_dir refs/ [--outdir wavs/] [--warmup] [--device cpu]

``--bundle DIR`` serves an exported bundle (``python -m
styler_tpu_torch.cli.export``) through ``core/export.py:BundleSynthesizer``:
one CUDA graph per (batch, src bucket, mel bucket) entry of the bundle,
captured at the entry's first request, or all before serving with
``--warmup``. A sentence past the bundle's largest src bucket is truncated
(``truncated`` in a batch reply), not chunked.

``Server.handle`` answers one request; ``main`` parses the flags and runs
the stdin loop. ``--bf16`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

from styler_tpu_torch.cli import add_model_flags, config_from_args, refuse_unported

#: the reply to a request with neither "sentence" nor "sentences"
CONTRACT = ("request needs 'sentence' or 'sentences' (plus 'ref'/'refs'), "
            "or cmd ping|shutdown")


class Server:
    """The request handler: the synthesizer, its config (reference dirs and
    sample rate), the output directory, the reference cache and the count
    of files written. ``handle(request) -> reply``; a failing request
    replies ``ok: false`` and leaves the server serving."""

    def __init__(self, synth, config, outdir: str):
        self.synth = synth
        self.config = config
        self.outdir = outdir
        self.ref_cache = {}
        self.n = 0
        os.makedirs(outdir, exist_ok=True)

    def get_ref(self, name, speaker_id, noisy):
        from styler_tpu_torch.synthesis import load_reference

        key = (name, speaker_id, bool(noisy))
        if key not in self.ref_cache:
            self.ref_cache[key] = load_reference(
                self.config, self.synth.frontend, name, speaker_id, noisy
            )
        return self.ref_cache[key]

    def _write(self, result, base: str, noisy_path: str) -> None:
        from styler_tpu_torch.data.audio_io import audiowrite

        audiowrite(result["wav"], self.config.sampling_rate, base)
        audiowrite(result["wav_noisy"], self.config.sampling_rate, noisy_path)
        self.n += 1

    def handle(self, req: dict) -> dict:
        rid = req.get("id")
        if req.get("cmd") == "ping":
            return {"id": rid, "ok": True, "pong": True}
        if req.get("cmd") == "shutdown":
            return {"id": rid, "ok": True, "bye": True}
        if "sentence" not in req and "sentences" not in req:
            return {"id": rid, "ok": False, "error": CONTRACT}
        try:
            controls = {k: float(req.get(k, 1.0))
                        for k in ("d_control", "p_control", "e_control")}
            t0 = time.perf_counter()
            if "sentences" in req:
                out = self._batch(req, controls)
            else:
                out = self._single(req, controls)
            return {"id": rid, "ok": True, **out, "ms": round((time.perf_counter() - t0) * 1e3, 2)}
        except Exception as e:  # keep serving on per-request failures
            traceback.print_exc(file=sys.stderr)
            return {"id": rid, "ok": False, "error": f"{type(e).__name__}: {e}"}

    def _single(self, req: dict, controls: dict) -> dict:
        ref, spk = self.get_ref(req["ref"], req.get("speaker_id"), req.get("noisy_input", False))
        result = self.synth.synthesize(req["sentence"], ref, spk, **controls)
        base = req.get("out") or os.path.join(self.outdir, f"{self.n:06d}.wav")
        root, ext = os.path.splitext(base)
        if ext.lower() != ".wav":  # only wav output is supported
            root, base = base, base + ".wav"
        noisy_path = root + "_noisy.wav"
        self._write(result, base, noisy_path)
        return {"wav": base, "wav_noisy": noisy_path, "mel_len": int(result["mel_len"])}

    def _batch(self, req: dict, controls: dict) -> dict:
        sents = list(req["sentences"])
        if not sents:
            raise ValueError("empty 'sentences' list")
        # explicit-but-empty "refs" is a length mismatch, not a fallback
        names = list(req["refs"]) if "refs" in req else [req["ref"]] * len(sents)
        if len(names) != len(sents):
            raise ValueError(f"refs ({len(names)}) must match sentences ({len(sents)})")
        pairs = [self.get_ref(nm, req.get("speaker_id"), req.get("noisy_input", False))
                 for nm in names]
        # pad to the next power of two: few distinct batch shapes
        pad = (1 << max(len(sents) - 1, 0).bit_length()) - len(sents)
        results = self.synth.synthesize_batch(
            sents + [sents[-1]] * pad,
            [p[0] for p in pairs] + [pairs[-1][0]] * pad,
            [p[1] for p in pairs] + [pairs[-1][1]] * pad,
            **controls,
        )[: len(sents)]
        out = {"wavs": [], "wavs_noisy": [], "mel_lens": []}
        for r in results:
            base = os.path.join(self.outdir, f"{self.n:06d}.wav")
            noisy_path = base[:-4] + "_noisy.wav"
            self._write(r, base, noisy_path)
            out["wavs"].append(base)
            out["wavs_noisy"].append(noisy_path)
            out["mel_lens"].append(int(r["mel_len"]))
        # the batch path clamps over-long inputs (it cannot chunk like the
        # single path): say which items lost content
        if any(r["truncated"] for r in results):
            out["truncated"] = [bool(r["truncated"]) for r in results]
        return out


def warmup_batch_sizes(largest: int) -> tuple:
    """Every power of two up to the one that holds ``largest``: the batch
    sizes a request of at most ``largest`` sentences pads to."""
    top = 1 << (largest - 1).bit_length()
    sizes = [1]
    while sizes[-1] < top:
        sizes.append(sizes[-1] * 2)
    return tuple(sizes)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog="python -m styler_tpu_torch.cli.serve",
                                     description="JSON-lines synthesis server.")
    add_model_flags(parser)
    parser.add_argument("--bundle", type=str, default=None,
                        help="serve an exported bundle (CUDA graphs per bucket entry); the "
                             "weight and bucket flags are then the bundle's")
    parser.add_argument("--outdir", type=str, default="serve_out")
    parser.add_argument("--warmup", action="store_true",
                        help="one forward per (batch, src, mel) bucket before serving; with "
                             "--bundle, every entry of the bundle captured and replayed")
    parser.add_argument("--warmup_batches", type=int, nargs="+", default=[1],
                        help="largest batch size to warm; expanded to every power of "
                             "two up to it")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    refuse_unported(args)

    # Own stdout: replies go to a private duplicate of it, and both
    # sys.stdout and file descriptor 1 point at stderr before the port is
    # imported, so no print, build log or native library notice can
    # corrupt the JSON-lines protocol.
    reply_stream = os.fdopen(os.dup(sys.stdout.fileno()), "w", buffering=1)
    sys.stdout.flush()
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    sys.stdout = sys.stderr

    cfg = config_from_args(args)
    if args.bundle:
        from styler_tpu_torch.core.export import BundleSynthesizer

        synth = BundleSynthesizer(args.bundle, cfg, device=args.device)
    else:
        from styler_tpu_torch.synthesis import load_synthesizer

        synth = load_synthesizer(cfg, args.ckpt, args.vocoder_ckpt, vocoder_arch=args.vocoder,
                                 device=args.device)
    server = Server(synth, cfg, args.outdir)
    if args.warmup:
        t0 = time.perf_counter()
        if args.bundle:  # every entry of the bundle, whatever --warmup_batches says
            n_warm = synth.warmup()
        else:
            n_warm = synth.warmup(batches=warmup_batch_sizes(max(args.warmup_batches)))
        print(f"warmup: {n_warm} forwards in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)

    def reply(obj):
        reply_stream.write(json.dumps(obj) + "\n")
        reply_stream.flush()

    print("serving (JSON lines on stdin)...", file=sys.stderr, flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            reply({"ok": False, "error": f"bad json: {e}"})
            continue
        if not isinstance(req, dict):
            reply({"ok": False, "error": "a request is a JSON object"})
            continue
        reply(server.handle(req))
        if req.get("cmd") == "shutdown":
            break
    return 0


if __name__ == "__main__":
    sys.exit(main())
