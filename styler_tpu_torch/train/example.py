"""Example batches and an example on-disk dataset, made from a seed.

``example_batch`` is the port's copy of the repository's
``__graft_entry__._example_batch`` (random features of the right shapes
and ranges), extended with ragged lengths: ``src_len`` and ``mel_len`` are
drawn from the seed and every duration row holds values >= 1 on its valid
phonemes that sum to the row's ``mel_len``. ``write_example_dataset``
writes such utterances to disk in the 11-array contract of
``data/dataset.py``, so the trainer has a dataset on a machine with none.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from styler_tpu_torch.core.config import Config
from styler_tpu_torch.textproc.symbols import ARPABET


def _durations(rng, n_src: int, n_mel: int) -> np.ndarray:
    """n_src durations >= 1 that sum to n_mel."""
    d = np.ones(n_src, dtype=np.int32)
    extra = rng.multinomial(n_mel - n_src, np.full(n_src, 1.0 / n_src))
    return d + extra.astype(np.int32)


def _features(rng, cfg: Config, n_mel: int) -> Dict[str, np.ndarray]:
    """Frame-domain features of one utterance, in the value ranges of the
    preprocessed corpus: log-mels, f0 in Hz with unvoiced zeros, energies,
    and their [0, 1]-normalised model inputs, clean and augmented."""
    voiced = rng.random(n_mel) > 0.3
    f0 = (rng.random(n_mel) * 300 + 80).astype(np.float32) * voiced
    f0_norm = rng.random(n_mel).astype(np.float32) * voiced
    noise = rng.standard_normal((n_mel, cfg.n_mel_channels)).astype(np.float32)
    mel = (rng.standard_normal((n_mel, cfg.n_mel_channels)) * 2 - 5).astype(np.float32)
    return {
        "mel_clean": mel,
        "mel_aug": mel + 0.5 * noise,
        "f0": f0,
        "f0_norm": f0_norm,
        "f0_norm_aug": np.clip(f0_norm + 0.05 * rng.standard_normal(n_mel), 0, 1).astype(np.float32)
        * voiced,
        "energy": (rng.random(n_mel) * 100).astype(np.float32),
        "energy_0to1": rng.random(n_mel).astype(np.float32),
        "energy_0to1_aug": rng.random(n_mel).astype(np.float32),
    }


def example_batch(
    cfg: Config, B: int = 2, L: int = 16, M: int = 64, seed: int = 0, ragged: bool = True,
) -> Dict[str, np.ndarray]:
    """A padded numpy batch of B utterances at phoneme axis L and frame
    axis M. The first row fills both axes; with ``ragged`` the others draw
    src_len in [L/2, L] and mel_len in [max(src_len, M/2), M]."""
    rng = np.random.default_rng(seed)
    src_len = np.full(B, L, dtype=np.int32)
    mel_len = np.full(B, M, dtype=np.int32)
    if ragged:
        for b in range(1, B):
            src_len[b] = rng.integers(max(L // 2, 1), L + 1)
            mel_len[b] = rng.integers(max(int(src_len[b]), M // 2), M + 1)

    def rows(draw, lengths, dtype=np.float32):
        out = np.zeros((B, M if lengths is mel_len else L), dtype=dtype)
        for b in range(B):
            out[b, : lengths[b]] = draw(int(lengths[b]))
        return out

    def mels():
        out = np.zeros((B, M, cfg.n_mel_channels), dtype=np.float32)
        for b in range(B):
            out[b, : mel_len[b]] = rng.standard_normal((int(mel_len[b]), cfg.n_mel_channels))
        return out

    batch = dict(
        src_seq=rows(lambda n: rng.integers(1, 100, size=n), src_len, np.int32),
        mel_target=mels(),
        mel_aug=mels(),
        p_norm=rows(lambda n: rng.random(n), mel_len),
        e_input=rows(lambda n: rng.random(n), mel_len),
        src_len=src_len,
        mel_len=mel_len,
        speaker_embed=rng.standard_normal((B, cfg.speaker_embed_dim)).astype(np.float32),
    )
    d = np.zeros((B, L), dtype=np.int32)
    for b in range(B):
        d[b, : src_len[b]] = _durations(rng, int(src_len[b]), int(mel_len[b]))
    batch.update(
        d_target=d,
        p_target=rows(lambda n: rng.random(n) * 300 + 80, mel_len),
        e_target=rows(lambda n: rng.random(n) * 100, mel_len),
        log_d_target=np.log(d + cfg.log_offset).astype(np.float32),
        f0_norm_aug=rows(lambda n: rng.random(n), mel_len),
        e_input_aug=rows(lambda n: rng.random(n), mel_len),
    )
    return batch


def write_example_dataset(
    directory: str, config: Config, n: int, seed: int = 0,
    src_len_range: Tuple[int, int] = (65, 128), mel_len_range: Tuple[int, int] = (520, 768),
    val: int = 0,
) -> Config:
    """Write ``n`` training utterances (and ``val`` validation ones) made
    from ``seed`` under ``directory`` in the on-disk contract of
    ``data/dataset.py``. Returns ``config`` pointed at them
    (``preprocessed_basedir=directory``). Lengths are drawn uniformly from
    the two ranges (inclusive); each utterance's durations are >= 1 and sum
    to its mel length."""
    rng = np.random.default_rng(seed)
    cfg = config.replace(preprocessed_basedir=os.path.abspath(directory))
    base = cfg.preprocessed_path
    kinds = {
        "mel_clean": "mel", "mel_aug": "mel", "alignment": "ali", "f0": "f0",
        "f0_norm": "f0", "f0_norm_aug": "f0", "energy": "energy",
        "energy_0to1": "energy", "energy_0to1_aug": "energy",
    }
    for sub in (*kinds, "spker_embed"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    speakers = [f"p{i:03d}" for i in range(4)]
    for spk in speakers:
        e = rng.standard_normal(cfg.speaker_embed_dim).astype(np.float32)
        np.save(os.path.join(base, "spker_embed", f"{cfg.dataset}-spker_embed-{spk}.npy"),
                e / np.linalg.norm(e))
    lines = []
    for i in range(n + val):
        name = f"{speakers[i % len(speakers)]}_{i:04d}"
        n_src = int(rng.integers(src_len_range[0], src_len_range[1] + 1))
        n_mel = int(rng.integers(max(mel_len_range[0], n_src), mel_len_range[1] + 1))
        arrays = _features(rng, cfg, n_mel)
        arrays["alignment"] = _durations(rng, n_src, n_mel)
        for sub, kind in kinds.items():
            np.save(os.path.join(base, sub, f"{cfg.dataset}-{kind}-{name}.npy"), arrays[sub])
        phones = " ".join(ARPABET[k] for k in rng.integers(0, len(ARPABET), n_src))
        lines.append(f"{name}|{{{phones}}}")
    for fname, part in (("train.txt", lines[:n]), ("val.txt", lines[n:])):
        with open(os.path.join(base, fname), "w", encoding="utf-8") as f:
            f.write("".join(line + "\n" for line in part))
    return cfg
