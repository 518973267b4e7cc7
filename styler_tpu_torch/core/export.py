"""Serving bundle: the weights and a manifest on disk, one CUDA graph per
shape bucket on the card (counterpart of ``styler_tpu/core/export.py``).

The JAX package serialises one StableHLO program per (batch, src_bucket,
mel_bucket) triple, so a serving process runs synthesis with no
model-building Python. A CUDA graph cannot be serialised: a bundle of the
port holds no program file, but what rebuilds the modules (the port's
``Config`` as JSON, whose ``compute_dtype`` makes a bundle of a bfloat16
acoustic model replay bfloat16, and the vocoder form, bf16 or int8) beside the weights
in the JAX package's flat layout. The port reads the JAX package's bundles
too (their ``.jaxexp`` files are ignored and the caller's config is
required, as for the JAX ``BundleSynthesizer``).

Bundle layout (one directory)::

    manifest.json   # entries, key lists, audio params, config, vocoder form
    weights.npz     # m00000.. / v00000.. leaves in jax.tree.leaves order

The leaves are those of ``{"params", "batch_stats"}`` and of the
vocoder's ``{"params"}`` as flax trees (``core/convert.py:to_flax_tree``),
in ``jax.tree.leaves`` order: dict keys sorted at every level, i.e. sorted
by the tuple of path parts (``batch_stats`` before ``params``).

On the card every entry runs as one ``torch.cuda.CUDAGraph`` that
captures the whole ``Synthesizer._forward`` (style encode, prediction, the
dual decode and one 2B-row vocoder pass: kernel A in the vocoder, kernel B
in the audio encoder), captured in ``warmup()`` or at the entry's first
call, after one eager forward at its shapes on a side stream. The graphs
share one memory pool. A call writes every element of the entry's static
inputs (the zero padding included, so a longer earlier request cannot
leak into a shorter one), replays once, copies the outputs to pinned host
memory and synchronises once; the next replay in the shared pool
overwrites the device outputs. A capture or replay that fails raises: there
is no eager fallback. On the CPU a call runs the eager forward with the
kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from styler_tpu_torch.core.config import Config
from styler_tpu_torch.core.convert import to_flax_tree
from styler_tpu_torch.core.device import resolve_device

FORMAT = "styler_tpu_torch.serving_bundle.v1"

_log = logging.getLogger("styler_tpu_torch.export")


def _entry_name(batch: int, src_bucket: int, mel_bucket: int) -> str:
    return f"fwd_b{batch}_L{src_bucket}_M{mel_bucket}"


def tree_leaves(tree: dict, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], object]]:
    """(path, leaf) pairs of a nested dict in ``jax.tree.leaves`` order:
    the keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(tree_leaves(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), v))
    return out


def tree_from_leaves(template: dict, flat: Sequence[np.ndarray], what: str) -> dict:
    """Flat leaves in ``template``'s leaf order -> a nested dict of the
    template's paths; raises unless the count and every shape agree."""
    paths = tree_leaves(template)
    if len(paths) != len(flat):
        raise ValueError(f"{what}: the bundle has {len(flat)} leaves, the model {len(paths)}")
    tree: dict = {}
    for (path, ref), leaf in zip(paths, flat):
        if tuple(np.shape(leaf)) != tuple(np.shape(ref)):
            raise ValueError(f"{what} leaf {'/'.join(path)}: shape {tuple(np.shape(leaf))}, "
                             f"the model's {tuple(np.shape(ref))}")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return tree


def load_flat_weights(bundle_dir: str, manifest: dict) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(model leaves, vocoder leaves) of ``weights.npz`` in order. Ordering
    contract: the manifest's key lists, or a numeric sort of the keys for
    v1 bundles that have none (a lexicographic sort scrambles the leaves
    at >= 1000); the leaf count must match the npz."""
    with np.load(os.path.join(bundle_dir, manifest["weights"])) as npz:
        files = list(npz.files)

        def numeric(pfx):
            return sorted((k for k in files if k.startswith(pfx)), key=lambda k: int(k[1:]))

        model_keys = manifest.get("model_weight_keys") or numeric("m")
        voc_keys = manifest.get("vocoder_weight_keys") or numeric("v")
        if len(model_keys) + len(voc_keys) != len(files):
            raise ValueError(f"weights.npz has {len(files)} arrays; manifest lists "
                             f"{len(model_keys)}+{len(voc_keys)}")
        return [npz[k] for k in model_keys], [npz[k] for k in voc_keys]


def config_from_json(obj: dict) -> Config:
    """A ``Config`` from the JSON of ``dataclasses.asdict``: lists back to
    tuples."""
    def tup(v):
        return tuple(tup(x) for x in v) if isinstance(v, list) else v

    return Config(**{k: tup(v) for k, v in obj.items()})


def _templates(config: Config) -> Tuple[dict, dict]:
    """The leaf paths and shapes of the model and vocoder trees, from
    freshly built modules."""
    from styler_tpu_torch.models import STYLER
    from styler_tpu_torch.vocoder import make_generator

    params, stats = to_flax_tree(STYLER(config))
    vparams, _ = to_flax_tree(make_generator(config.vocoder))
    return {"params": params, "batch_stats": stats}, {"params": vparams}


def save_serving_bundle(
    synth,
    out_dir: str,
    src_buckets: Optional[Sequence[int]] = None,
    mel_buckets: Optional[Sequence[int]] = None,
    batch=1,
) -> Dict:
    """Write ``manifest.json`` and ``weights.npz`` of ``synth`` (a
    ``Synthesizer``) for every (batch, src_bucket, mel_bucket) triple into
    ``out_dir``. ``batch`` is an int or a sequence of batch sizes (e.g.
    ``(1, 8)`` so batched serve requests keep one replay per group).
    Returns the manifest dict. Nothing is captured here: the graphs are
    made where the bundle is served."""
    cfg = synth.config
    src_buckets = tuple(src_buckets or cfg.src_buckets)
    mel_buckets = tuple(mel_buckets or cfg.mel_buckets)
    batches = (batch,) if isinstance(batch, int) else tuple(batch)
    # the output mel cap follows the EFFECTIVE bucket list, so an override
    # larger than the config's never caps outputs below its input bucket
    mel_out = max(mel_buckets)
    os.makedirs(out_dir, exist_ok=True)

    params, stats = to_flax_tree(synth.model)
    vparams, _ = to_flax_tree(synth.generator)
    blob, model_keys, voc_keys = {}, [], []
    for prefix, keys, tree in (("m", model_keys, {"params": params, "batch_stats": stats}),
                               ("v", voc_keys, {"params": vparams})):
        for i, (_, leaf) in enumerate(tree_leaves(tree)):
            k = f"{prefix}{i:05d}"
            blob[k] = np.asarray(leaf)
            keys.append(k)
    np.savez(os.path.join(out_dir, "weights.npz"), **blob)

    entries = [{"name": _entry_name(B, L, M), "batch": B, "src_bucket": L, "mel_bucket": M}
               for B in batches for L in src_buckets for M in mel_buckets]
    manifest = {
        "format": FORMAT,
        "entries": entries,
        "weights": "weights.npz",
        "model_weight_keys": model_keys,
        "vocoder_weight_keys": voc_keys,
        # kernel A is the port's only vocoder path on the card: the JAX
        # package's fused export
        "fused_vocoder": True,
        "vocoder_form": "int8" if synth.int8_vocoder and cfg.vocoder == "HiFi-GAN" else "bf16",
        "audio": {
            "sampling_rate": cfg.sampling_rate,
            "hop_length": cfg.hop_length,
            "n_mel_channels": cfg.n_mel_channels,
            "mel_out": mel_out,
        },
        "speaker_embed_dim": cfg.speaker_embed_dim,
        "vocoder": cfg.vocoder,
        "config": dataclasses.asdict(cfg.replace(src_buckets=src_buckets, mel_buckets=mel_buckets)),
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _input_specs(B: int, L: int, M: int, n_mels: int, spk_dim: int) -> list:
    """(shape, dtype, fill) of an entry's inputs: src_seq, src_len, mel,
    f0_norm, energy01, mel_len, speaker_embed and the [3] controls."""
    i64, f32 = torch.int64, torch.float32
    return [((B, L), i64, 0), ((B,), i64, 1), ((B, M, n_mels), f32, 0), ((B, M), f32, 0),
            ((B, M), f32, 0), ((B,), i64, 1), ((B, spk_dim), f32, 0), ((3,), f32, 1)]


def _outputs(out, wav, wav_noisy) -> Dict[str, torch.Tensor]:
    """The forward's outputs under the keys of the JAX package's program."""
    return {"mel_postnet": out.mel_postnet, "mel_postnet_noisy": out.mel_postnet_noisy,
            "wav": wav, "wav_noisy": wav_noisy, "mel_len": out.mel_len,
            "f0": out.p_prediction, "energy": out.e_prediction, "log_d": out.log_d_prediction}


def _forward(synth, inputs: Sequence[torch.Tensor], mel_out: int) -> Dict[str, torch.Tensor]:
    ctrl = inputs[7]
    return _outputs(*synth._forward(*inputs[:7], ctrl[0], ctrl[1], ctrl[2], mel_out))


class _EntryGraph:
    """One entry on the card: static inputs with pinned staging buffers,
    the captured graph, its static outputs and pinned host copies."""

    def __init__(self, synth, specs, mel_out: int, pool):
        dev = synth.device
        self.inputs = [torch.full(shape, fill, dtype=dt, device=dev) for shape, dt, fill in specs]
        self.staging = [torch.empty(shape, dtype=dt, pin_memory=True) for shape, dt, _ in specs]
        self.staging_np = [t.numpy() for t in self.staging]
        # one eager forward at the entry's shapes on a side stream builds
        # the kernels, the cuFFT plans, cuDNN's choices and the per-shape
        # tables, none of which a capture may make
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _forward(synth, self.inputs, mel_out)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, pool=pool):
            self.outputs = _forward(synth, self.inputs, mel_out)
        self.host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                     for k, v in self.outputs.items()}
        self.host_np = {k: v.numpy() for k, v in self.host.items()}

    def run(self, arrays) -> Dict[str, np.ndarray]:
        """Write every input element, replay, copy the outputs to the host
        and synchronise once. The returned arrays are the pinned buffers,
        which the next call overwrites."""
        for stage, stage_np, static, a in zip(self.staging, self.staging_np, self.inputs, arrays):
            stage_np[...] = a
            static.copy_(stage, non_blocking=True)
        self.graph.replay()
        for k, v in self.outputs.items():
            self.host[k].copy_(v, non_blocking=True)
        torch.cuda.current_stream(self.inputs[0].device).synchronize()
        return self.host_np


class ServingBundle:
    """Load and run a serving bundle (the port's or the JAX package's).

    >>> b = ServingBundle(path)                      # CUDA graphs per entry
    >>> out = b.synthesize(ids, mel, f0_norm, energy01)   # numpy in/out

    ``config``: required for a bundle of the JAX package, which holds
    none (its vocoder arch comes from the manifest, its vocoder form from
    ``STYLER_TPU_INT8_VOCODER``); a bundle of the port rebuilds its modules
    from its own config and form. ``device``: CUDA unless ``"cpu"``."""

    def __init__(self, bundle_dir: str, config: Optional[Config] = None, device=None):
        from styler_tpu_torch.synthesis import Synthesizer

        self.dir = bundle_dir
        with open(os.path.join(bundle_dir, "manifest.json")) as f:
            self.manifest = json.load(f)
        if self.manifest.get("format") == FORMAT:
            config = config_from_json(self.manifest["config"])
            int8 = self.manifest["vocoder_form"] == "int8"
        elif config is None:
            raise ValueError(f"{bundle_dir}: a bundle of the JAX package holds no config; "
                             "pass the config it was exported with")
        else:
            config = config.replace(vocoder=self.manifest["vocoder"])
            int8 = None
        self.config = config
        model_flat, voc_flat = load_flat_weights(bundle_dir, self.manifest)
        model_t, voc_t = _templates(config)
        model = tree_from_leaves(model_t, model_flat, "model")
        voc = tree_from_leaves(voc_t, voc_flat, "vocoder")
        self.synth = Synthesizer(config, model["params"], model.get("batch_stats", {}),
                                 voc["params"], resolve_device(device), int8_vocoder=int8)
        self.device = self.synth.device
        a = self.manifest["audio"]
        self._entries = {(e["batch"], e["src_bucket"], e["mel_bucket"]): e
                         for e in self.manifest["entries"]}
        self.mel_out = a.get("mel_out") or max(k[2] for k in self._entries)
        self._graphs: Dict[Tuple[int, int, int], _EntryGraph] = {}
        self._pool = None

    def _specs(self, key):
        return _input_specs(*key, self.manifest["audio"]["n_mel_channels"],
                            self.manifest["speaker_embed_dim"])

    def graph(self, key) -> _EntryGraph:
        """The entry's graph, captured at its first use (CUDA only)."""
        g = self._graphs.get(key)
        if g is None:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            g = self._graphs[key] = _EntryGraph(self.synth, self._specs(key), self.mel_out,
                                                self._pool)
        return g

    def _run(self, key, arrays) -> Dict[str, np.ndarray]:
        if key not in self._entries:
            raise KeyError(f"no entry {_entry_name(*key)} in {self.dir}")
        specs = self._specs(key)
        if len(arrays) != 10:
            raise ValueError(f"a call takes 10 arrays, got {len(arrays)}")
        arrays = list(arrays[:7]) + [np.asarray(arrays[7:], np.float32)]
        for (shape, _, _), a, name in zip(specs, arrays, ("src_seq", "src_len", "mel", "f0_norm",
                                                          "energy01", "mel_len", "speaker_embed",
                                                          "controls")):
            if tuple(np.shape(a)) != shape:
                raise ValueError(f"{_entry_name(*key)}: {name} {tuple(np.shape(a))}, expected {shape}")
        if self.device.type == "cuda":
            return self.graph(key).run(arrays)
        inputs = [torch.from_numpy(np.asarray(a)).to(dt) for (_, dt, _), a in zip(specs, arrays)]
        return {k: v.numpy() for k, v in _forward(self.synth, inputs, self.mel_out).items()}

    def call(self, batch, src_bucket, mel_bucket, *arrays) -> Dict[str, np.ndarray]:
        """One run of the entry on numpy inputs (src_seq, src_len, mel,
        f0_norm, energy01, mel_len, speaker_embed, d_control, p_control,
        e_control) -> a dict of numpy outputs under the JAX program's keys
        (mel_postnet, mel_postnet_noisy, wav, wav_noisy, mel_len, f0,
        energy, log_d), copies of the host buffers."""
        out = self._run((batch, src_bucket, mel_bucket), arrays)
        return {k: np.array(v) for k, v in out.items()}

    def _bucket(self, idx: int, n: int) -> int:
        opts = sorted({k[idx] for k in self._entries})
        for o in opts:
            if n <= o:
                return o
        raise ValueError(f"no exported bucket >= {n} (have {opts})")

    def _pick_batch(self, n: int) -> int:
        """Smallest exported batch >= n, else the largest (callers chunk)."""
        batches = sorted({k[0] for k in self._entries})
        for b in batches:
            if n <= b:
                return b
        return batches[-1]

    def warmup(self) -> int:
        """Run every entry once on zero inputs (on the card: capture its
        graph and replay it) so that no request pays for a capture.
        Returns the entry count."""
        for key in self._entries:
            arrays = [np.full(shape, fill, np.float32) for shape, _, fill in self._specs(key)]
            self._run(key, arrays[:7] + [1.0, 1.0, 1.0])
        return len(self._entries)

    def _clamp_row(self, ids, mel, f0_norm, energy01):
        """Bound one row to the largest exported buckets; the final bool
        says whether anything was cut (``truncated`` in the result). A
        sentence past the largest src bucket is truncated, not chunked."""
        L_max = max(k[1] for k in self._entries)
        M_max = max(k[2] for k in self._entries)
        cut = False
        if len(ids) > L_max:
            _log.warning("sentence has %d phonemes > largest exported src bucket %d; truncating",
                         len(ids), L_max)
            ids = ids[:L_max]
            cut = True
        if len(f0_norm) > M_max:
            _log.warning("reference has %d mel frames > largest exported mel bucket %d; trimming",
                         len(f0_norm), M_max)
            mel, f0_norm, energy01 = mel[:M_max], f0_norm[:M_max], energy01[:M_max]
            cut = True
        return ids, mel, f0_norm, energy01, cut

    def synthesize(self, ids, mel, f0_norm, energy01, speaker_embed=None,
                   d_control: float = 1.0, p_control: float = 1.0, e_control: float = 1.0) -> Dict:
        """One sentence (phoneme ids) + reference features -> a dict of
        numpy outputs, padded into the nearest exported bucket pair."""
        return self.synthesize_batch(
            [ids], [mel], [f0_norm], [energy01],
            None if speaker_embed is None else [speaker_embed],
            d_control=d_control, p_control=p_control, e_control=e_control,
        )[0]

    def synthesize_batch(self, ids_list, mels, f0_norms, energy01s, speaker_embeds=None,
                         d_control: float = 1.0, p_control: float = 1.0,
                         e_control: float = 1.0) -> List[Dict]:
        """N items through the batch-B entries: padded up to the smallest
        exported batch that holds them (one replay), or chunked by the
        largest exported batch when they exceed every exported size."""
        n = len(ids_list)
        if n == 0:
            raise ValueError("empty batch")
        rows = [self._clamp_row(ids_list[i], mels[i], f0_norms[i], energy01s[i])
                for i in range(n)]
        results: List[Dict] = []
        i = 0
        while i < n:
            B = self._pick_batch(n - i)
            take = min(B, n - i)
            results.extend(self._call_group(
                rows[i: i + take],
                None if speaker_embeds is None else speaker_embeds[i: i + take],
                B, d_control, p_control, e_control,
            ))
            i += take
        return results

    def _call_group(self, rows, spk_rows, B, d_control, p_control, e_control):
        a = self.manifest["audio"]
        n = len(rows)
        L = self._bucket(1, max(len(r[0]) for r in rows))
        M = self._bucket(2, max(len(r[2]) for r in rows))
        src_seq = np.zeros((B, L), np.int32)
        src_len = np.ones(B, np.int32)
        mel_in = np.zeros((B, M, a["n_mel_channels"]), np.float32)
        f0 = np.zeros((B, M), np.float32)
        en = np.zeros((B, M), np.float32)
        mel_len = np.ones(B, np.int32)
        spk = np.zeros((B, self.manifest["speaker_embed_dim"]), np.float32)
        for i in range(B):
            ids, m, f, e, _ = rows[min(i, n - 1)]  # pad rows repeat the last
            k = len(f)
            src_seq[i, : len(ids)] = ids
            src_len[i] = len(ids)
            mel_in[i, :k] = m[:k]
            f0[i, :k] = f[:k]
            en[i, :k] = e[:k]
            mel_len[i] = k
            if spk_rows is not None:
                spk[i] = np.ravel(spk_rows[min(i, n - 1)])
        out = self._run((B, L, M), (src_seq, src_len, mel_in, f0, en, mel_len, spk,
                                    d_control, p_control, e_control))
        results = []
        for i in range(n):
            ml = int(out["mel_len"][i])
            ns = ml * a["hop_length"]
            results.append({
                "mel": out["mel_postnet"][i, :ml].copy(),
                "mel_noisy": out["mel_postnet_noisy"][i, :ml].copy(),
                "wav": out["wav"][i, :ns].copy(),
                "wav_noisy": out["wav_noisy"][i, :ns].copy(),
                "f0": out["f0"][i, :ml].copy(),
                "energy": out["energy"][i, :ml].copy(),
                "mel_len": ml,
                "truncated": rows[i][4],
            })
        return results


class BundleSynthesizer:
    """The ``Synthesizer.synthesize`` surface (text + ReferenceFeatures +
    speaker embedding -> result dict) over a serving bundle, so that
    ``cli/serve.py --bundle DIR`` serves it. Text and the mel front end run
    on the host as in the live path; the device work is the bundle's.

    Requests land in the bundle's buckets: export with the
    ``--src_buckets/--mel_buckets`` you plan to serve."""

    def __init__(self, bundle_dir: str, config: Config, device=None):
        from styler_tpu_torch.dsp.mel import MelFrontend
        from styler_tpu_torch.textproc import text_to_sequence, to_phoneme_string

        self.bundle = ServingBundle(bundle_dir, config, device)
        self.config = config
        self.frontend = MelFrontend(config, self.bundle.device)
        self._g2p = self.bundle.synth.g2p
        self._to_phoneme_string = to_phoneme_string
        self._text_to_sequence = text_to_sequence

    def text_to_ids(self, sentence: str) -> np.ndarray:
        return np.asarray(
            self._text_to_sequence(self._to_phoneme_string(sentence, self._g2p),
                                   list(self.config.text_cleaners)),
            dtype=np.int32,
        )

    def synthesize(self, sentence: str, ref, speaker_embed: np.ndarray,
                   d_control: float = 1.0, p_control: float = 1.0,
                   e_control: float = 1.0) -> Dict:
        return self.bundle.synthesize(
            self.text_to_ids(sentence), ref.mel[: ref.mel_len], ref.f0_norm[: ref.mel_len],
            ref.energy01[: ref.mel_len], speaker_embed,
            d_control=d_control, p_control=p_control, e_control=e_control,
        )

    def synthesize_batch(self, sentences, refs, speaker_embeds, mesh=None,
                         d_control: float = 1.0, p_control: float = 1.0,
                         e_control: float = 1.0, ids_rows=None):
        """Batched serving through the bundle's batch-N entries (padded to
        the smallest exported batch that holds the request, chunked by
        the largest otherwise): one replay per group. ``mesh`` is accepted
        for signature parity and ignored, as the JAX package's adapter
        does."""
        ids = ids_rows if ids_rows is not None else [self.text_to_ids(s) for s in sentences]
        return self.bundle.synthesize_batch(
            ids,
            [r.mel[: r.mel_len] for r in refs],
            [r.f0_norm[: r.mel_len] for r in refs],
            [r.energy01[: r.mel_len] for r in refs],
            speaker_embeds,
            d_control=d_control, p_control=p_control, e_control=e_control,
        )

    def warmup(self) -> int:
        """Every entry (``ServingBundle.warmup``: on the card, every graph
        captured and replayed once) plus the mel front end at 256 and 1024
        frames. Returns the entry count."""
        n = self.bundle.warmup()
        for F in (256, 1024):
            self.frontend(np.zeros((F - 1) * self.config.hop_length, np.float32))
        return n
