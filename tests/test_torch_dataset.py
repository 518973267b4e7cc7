"""The port's host loader against the JAX package's on one example dataset
written to disk: equal samples, padded batches and batch order."""

import dataclasses

import numpy as np
import pytest
import torch

from styler_tpu.core.config import default_config as j_config
from styler_tpu.data import dataset as j_data
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.data import dataset as t_data
from styler_tpu_torch.train.example import example_batch, write_example_dataset

N, BS = 11, 2
BATCH_KEYS = {
    "id", "src_seq", "mel_target", "mel_aug", "d_target", "log_d_target", "p_target", "p_norm",
    "f0_norm_aug", "e_target", "e_input", "e_input_aug", "speaker_embed", "src_len", "mel_len",
}


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    root = tmp_path_factory.mktemp("example")
    cfg = write_example_dataset(
        str(root), default_config().replace(batch_size=BS), N, seed=3,
        src_len_range=(5, 40), mel_len_range=(30, 200), val=3,
    )
    # the JAX package's config from the same fields
    jcfg = j_config().replace(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
        if hasattr(j_config(), f.name)
    })
    return cfg, jcfg


def _same(got, want):
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def test_written_dataset_has_the_contract(configs):
    cfg, _ = configs
    ds = t_data.Dataset(cfg, "train.txt")
    assert len(ds) == N and len(t_data.Dataset(cfg, "val.txt")) == 3
    for i in range(N):
        s = ds[i]
        n_src, n_mel = len(s["text"]), s["mel_target"].shape[0]
        assert 5 <= n_src <= 40 and max(30, n_src) <= n_mel <= 200
        assert s["D"].shape == (n_src,) and s["D"].min() >= 1 and s["D"].sum() == n_mel
        for k in ("f0", "f0_norm", "f0_norm_aug", "energy", "energy_input", "energy_input_aug"):
            assert s[k].shape == (n_mel,)
        assert s["mel_aug"].shape == (n_mel, 80) and s["speaker_embed"].shape == (512,)
        assert 0 <= s["f0_norm"].min() and s["f0_norm"].max() <= 1 and (s["f0"] == 0).any()


def test_samples_match_jax(configs):
    cfg, jcfg = configs
    got, want = t_data.Dataset(cfg), j_data.Dataset(jcfg)
    assert len(got) == len(want)
    for i in (0, 5, N - 1):
        a, b = got[i], want[i]
        assert set(a) == set(b)
        for k in b:
            _same(a[k], b[k])


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, False), (True, True)])
def test_batches_match_jax_for_two_epochs(configs, shuffle, drop_last):
    cfg, jcfg = configs
    n_batches = 0
    for epoch in range(2):
        got = list(t_data.batch_iterator(t_data.Dataset(cfg), cfg, shuffle, drop_last, 7, epoch))
        want = list(j_data.batch_iterator(j_data.Dataset(jcfg), jcfg, shuffle, drop_last, 7, epoch))
        assert len(got) == len(want) == t_data.batches_per_epoch(N, cfg, drop_last)
        for a, b in zip(got, want):
            assert set(a) == set(b) == BATCH_KEYS
            for k in b:
                _same(a[k], b[k])
            assert a["src_seq"].shape[1] in cfg.src_buckets
            assert a["mel_target"].shape[1] in cfg.mel_buckets
        n_batches += len(got)
    assert n_batches == 2 * (N // (BS * BS)) * BS if drop_last else n_batches > 0


@pytest.mark.parametrize("n,bs,drop_last", [(64, 16, False), (300, 16, True), (11, 2, True),
                                            (11, 2, False), (3, 2, True)])
def test_batches_per_epoch_matches_jax(n, bs, drop_last):
    assert t_data.batches_per_epoch(n, default_config().replace(batch_size=bs), drop_last) == \
        j_data.batches_per_epoch(n, j_config().replace(batch_size=bs), drop_last)


def test_prefetch_yields_all_items_in_order():
    assert list(t_data.prefetch(iter(range(25)), size=2)) == list(range(25))
    assert list(t_data.prefetch(iter(()))) == []


def test_batch_to_device_dtypes(configs):
    cfg, _ = configs
    batch = next(t_data.batch_iterator(t_data.Dataset(cfg), cfg, drop_last=False))
    dev = t_data.batch_to_device(batch, "cpu")
    assert set(dev) == BATCH_KEYS - {"id"} == set(t_data.strip_host_fields(batch))
    for k, v in dev.items():
        want = torch.int64 if batch[k].dtype.kind == "i" else torch.float32
        assert v.dtype == want and tuple(v.shape) == batch[k].shape, k
        np.testing.assert_array_equal(v.numpy(), batch[k])


@pytest.mark.parametrize("ragged", [True, False])
def test_example_batch_is_consistent(ragged):
    cfg = default_config()
    b = example_batch(cfg, B=4, L=12, M=48, seed=1, ragged=ragged)
    assert set(b) == BATCH_KEYS - {"id"}
    assert b["src_len"][0] == 12 and b["mel_len"][0] == 48
    assert ragged == bool((b["mel_len"] < 48).any() or (b["src_len"] < 12).any())
    for i in range(4):
        n_src, n_mel = b["src_len"][i], b["mel_len"][i]
        assert b["d_target"][i, :n_src].min() >= 1 and b["d_target"][i].sum() == n_mel
        assert np.all(b["d_target"][i, n_src:] == 0) and np.all(b["src_seq"][i, n_src:] == 0)
        assert np.all(b["src_seq"][i, :n_src] > 0)
        assert np.all(b["mel_target"][i, n_mel:] == 0) and np.all(b["p_target"][i, n_mel:] == 0)
    np.testing.assert_allclose(b["log_d_target"], np.log(b["d_target"] + cfg.log_offset), rtol=1e-6)
    again = example_batch(cfg, B=4, L=12, M=48, seed=1, ragged=ragged)
    for k in b:
        np.testing.assert_array_equal(b[k], again[k])
