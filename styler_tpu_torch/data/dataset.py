"""Training dataset and bucketed host loader (a copy of the numpy host
code of ``styler_tpu/data/dataset.py``, plus the move to the device).

On-disk contract, identical to the reference (dataset.py:84-131): 11
precomputed ``.npy`` arrays per utterance under
``<preprocessed>/<dataset>/{mel_clean,mel_aug,alignment,f0,f0_norm,
f0_norm_aug,energy,energy_0to1,energy_0to1_aug,spker_embed}`` plus
``train.txt``/``val.txt`` ("basename|phoneme text" lines).

Batching keeps the reference's sorted batch-of-batches trick
(dataset.py:188-207: load batch_size^2, sort by text length descending,
cut into batch_size sub-batches) and pads every sub-batch to static shape
buckets (config.src_buckets / mel_buckets), so the LSTM kernels and cuDNN
see a handful of shapes. log_D = log(D + log_offset) is computed here like
the reference collate (dataset.py:167).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from styler_tpu_torch.core.config import Config, bucket_for
from styler_tpu_torch.textproc import text_to_sequence


def process_meta(meta_path: str) -> Tuple[List[str], List[str]]:
    names, texts = [], []
    with open(meta_path, encoding="utf-8") as f:
        for line in f:
            n, t = line.strip("\n").split("|")
            names.append(n)
            texts.append(t)
    return names, texts


class Dataset:
    def __init__(self, config: Config, filename: str = "train.txt"):
        self.config = config
        self.base = config.preprocessed_path
        self.basename, self.text = process_meta(os.path.join(self.base, filename))

    def __len__(self):
        return len(self.text)

    def _load(self, subdir: str, kind: str, basename: str) -> np.ndarray:
        return np.load(
            os.path.join(self.base, subdir, f"{self.config.dataset}-{kind}-{basename}.npy")
        )

    def __getitem__(self, idx: int) -> Dict:
        basename = self.basename[idx]
        speaker = basename.split("_")[0]
        spk_path = os.path.join(
            self.base, "spker_embed", f"{self.config.dataset}-spker_embed-{speaker}.npy"
        )
        return {
            "id": basename,
            "text": np.asarray(text_to_sequence(self.text[idx], []), dtype=np.int32),
            "mel_target": self._load("mel_clean", "mel", basename),
            "mel_aug": self._load("mel_aug", "mel", basename),
            "D": self._load("alignment", "ali", basename).astype(np.int32),
            "f0": self._load("f0", "f0", basename).astype(np.float32),
            "f0_norm": self._load("f0_norm", "f0", basename).astype(np.float32),
            "f0_norm_aug": self._load("f0_norm_aug", "f0", basename).astype(np.float32),
            "energy": self._load("energy", "energy", basename).astype(np.float32),
            "energy_input": self._load("energy_0to1", "energy", basename).astype(np.float32),
            "energy_input_aug": self._load("energy_0to1_aug", "energy", basename).astype(np.float32),
            "speaker_embed": np.load(spk_path).astype(np.float32),
        }


def pad_batch(samples: List[Dict], config: Config) -> Dict:
    """Pad a sub-batch to static shape buckets -> numpy arrays."""
    B = len(samples)
    src_lens = np.array([len(s["text"]) for s in samples], dtype=np.int32)
    mel_lens = np.array([s["mel_target"].shape[0] for s in samples], dtype=np.int32)
    L = bucket_for(int(src_lens.max()), config.src_buckets)
    M = bucket_for(int(mel_lens.max()), config.mel_buckets)

    def pad1(key, dtype, length_key):
        lengths = src_lens if length_key == "src" else mel_lens
        size = L if length_key == "src" else M
        out = np.zeros((B, size), dtype=dtype)
        for i, s in enumerate(samples):
            out[i, : lengths[i]] = s[key][: lengths[i]]
        return out

    mel_target = np.zeros((B, M, config.n_mel_channels), dtype=np.float32)
    mel_aug = np.zeros_like(mel_target)
    for i, s in enumerate(samples):
        mel_target[i, : mel_lens[i]] = s["mel_target"][: mel_lens[i]]
        mel_aug[i, : mel_lens[i]] = s["mel_aug"][: mel_lens[i]]

    d = pad1("D", np.int32, "src")
    return {
        "id": [s["id"] for s in samples],
        "src_seq": pad1("text", np.int32, "src"),
        "mel_target": mel_target,
        "mel_aug": mel_aug,
        "d_target": d,
        "log_d_target": np.log(d + config.log_offset).astype(np.float32),
        "p_target": pad1("f0", np.float32, "mel"),
        "p_norm": pad1("f0_norm", np.float32, "mel"),
        "f0_norm_aug": pad1("f0_norm_aug", np.float32, "mel"),
        "e_target": pad1("energy", np.float32, "mel"),
        "e_input": pad1("energy_input", np.float32, "mel"),
        "e_input_aug": pad1("energy_input_aug", np.float32, "mel"),
        "speaker_embed": np.concatenate(
            [s["speaker_embed"].reshape(1, -1) for s in samples], axis=0
        ),
        "src_len": src_lens,
        "mel_len": mel_lens,
    }


def batch_iterator(
    dataset: Dataset,
    config: Config,
    shuffle: bool = True,
    drop_last: bool = True,
    seed: int = 0,
    epoch: int = 0,
) -> Iterator[Dict]:
    """Reference batch-of-batches order: pool batch_size^2 examples, sort by
    text length descending, cut into batch_size sub-batches
    (dataset.py:188-207)."""
    bs = config.batch_size
    pool_size = bs * bs
    idx = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(idx)
    for start in range(0, len(idx), pool_size):
        pool_idx = idx[start: start + pool_size]
        if drop_last and len(pool_idx) < pool_size:
            break
        pool = [dataset[i] for i in pool_idx]
        order = np.argsort([-len(s["text"]) for s in pool])
        for j in range(0, len(pool), bs):
            cut = order[j: j + bs]
            if drop_last and len(cut) < bs:
                continue
            yield pad_batch([pool[k] for k in cut], config)


def batches_per_epoch(n: int, config: Config, drop_last: bool = True) -> int:
    """Sub-batches one epoch of :func:`batch_iterator` yields for an
    ``n``-example dataset: a pure function of (n, batch_size, drop_last),
    since pooling, sorting and cutting only reorder within fixed-size
    pools. Used for mid-epoch resume: a restored step maps to
    (epoch, offset) = divmod(step, batches_per_epoch(...)), so training
    continues on the batch sequence of an uninterrupted run."""
    bs = config.batch_size
    pool_size = bs * bs
    total = 0
    for start in range(0, n, pool_size):
        m = min(pool_size, n - start)
        if drop_last and m < pool_size:
            break
        total += m // bs if drop_last else -(-m // bs)
    return total


def strip_host_fields(batch: Dict) -> Dict:
    """Drop the non-array fields before the batch goes to the device."""
    return {k: v for k, v in batch.items() if k != "id"}


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A padded numpy batch as tensors on ``device``: float32 features,
    int64 ids, durations and lengths (what ``F.embedding``, ``cumsum`` and
    the gathers take without a cast). The copies are asynchronous from
    pinned memory where the device is a GPU."""
    device = torch.device(device)
    out = {}
    for k, v in strip_host_fields(batch).items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.to(torch.int64)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


def prefetch(iterator: Iterator, size: int = 2) -> Iterator:
    """Background-thread prefetcher: overlaps the host's npy loading and
    collation with the device's work."""
    q: "queue.Queue" = queue.Queue(maxsize=size)
    _END = object()

    def producer():
        try:
            for item in iterator:
                q.put(item)
        finally:
            q.put(_END)

    threading.Thread(target=producer, daemon=True).start()
    while True:
        item = q.get()
        if item is _END:
            return
        yield item
