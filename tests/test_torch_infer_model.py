"""The port's inference-only model methods against the JAX package's, on
the committed trained acoustic asset at src 32, mel 64, with the seeded
inputs of tests/test_torch_model.py (two rows of different lengths):

- ``STYLER.encode_style``: encodings, source mask and predicted length;
- ``StyleModeling.predict_inference`` on mixed encodings made from those
  encodings, with ``speaker_normalized`` True, False and per-row float
  weights [B], and with non-unit controls;
- ``STYLER.forward(..., residual=False)``: one B-row clean decode, the
  noisy slots holding the clean tensors.

Both sides run exact f32 with sums in another order: every float output
within 1e-4 of its scale (``max(max |x|, 1)``), as tests/test_torch_model.py;
masks and lengths exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from styler_tpu.core.checkpoint import load_acoustic_npz as j_load
from styler_tpu.core.config import default_config as j_config
from styler_tpu.models import STYLER as JSTYLER
from styler_tpu_torch.core.checkpoint import load_acoustic_npz
from styler_tpu_torch.core.config import default_config
from styler_tpu_torch.core.convert import load_flax_tree
from styler_tpu_torch.models import STYLER
from tests.test_torch_golden_cache import golden, torch_threads  # noqa: F401 (autouse)
from tests.test_torch_model import ASSET, B, L, M, inputs  # noqa: F401 (fixture)

REL = 1e-4
PIECES = ("text_f", "pitch_embedding", "speaker_f", "energy_embedding", "noise_f",
          "log_d_prediction", "p_prediction", "e_prediction", "mel_mask")
#: (speaker_normalized, (d, p, e) controls)
CASES = {
    "normalized": (True, (1.0, 1.0, 1.0)),
    "with_speaker": (False, (1.0, 1.0, 1.0)),
    "per_row": (np.array([1.0, 0.0], np.float32), (1.0, 1.0, 1.0)),
    "controls": (np.array([0.0, 1.0], np.float32), (1.3, 0.8, 1.2)),
}


def _mixed(enc):
    """Mixed [B, L, 256] streams in the order predict_inference takes them
    (text, pitch, energy, duration, speaker, noise): each row's pitch and
    energy streams from the other row, as mix_and_match crosses them."""
    swap = lambda x: x[np.array([1, 0])]  # noqa: E731
    tn = enc["t_neck"]
    return (enc["t"], tn + swap(enc["e"]), tn + enc["e"], tn + swap(enc["d"]), enc["s"], enc["n"])


def _jax_golden(src, mel, p, e, src_len, mel_len, spk):
    params, stats = j_load(ASSET)
    model = JSTYLER(j_config().replace(src_buckets=(L,), mel_buckets=(M,)))
    v = {"params": params, "batch_stats": stats}
    a = (jnp.asarray(src, jnp.int32), jnp.asarray(mel), jnp.asarray(p), jnp.asarray(e),
         jnp.asarray(src_len, jnp.int32), jnp.asarray(mel_len, jnp.int32), jnp.asarray(spk))
    kw = lambda a: dict(src_seq=a[0], mel_target=a[1], mel_aug=a[1], p_norm=a[2],  # noqa: E731
                        e_input=a[3], src_len=a[4], mel_len=a[5], max_src_len=L,
                        max_mel_len=M, speaker_embed=a[6])
    enc, src_mask, enc_len = jax.jit(
        lambda v, *a: model.apply(v, **kw(a), method="encode_style"))(v, *a)
    enc = {k: np.asarray(x) for k, x in enc.items()}
    off = jax.jit(lambda v, *a: model.apply(v, **kw(a), residual=False))(v, *a)
    pieces = {}
    for name, (sn, (dc, pc, ec)) in CASES.items():
        out = jax.jit(
            lambda v, *x, sn=sn, dc=dc, pc=pc, ec=ec: model.apply(
                v, *x, M, sn, dc, pc, ec,
                method=lambda m, *y: m.style_modeling.predict_inference(*y)),
        )(v, *_mixed(enc), src_mask)
        pieces[name] = [np.asarray(x) for x in out]
    return {
        "encode": (enc, np.asarray(src_mask), np.asarray(enc_len)),
        "residual_off": {k: np.asarray(x) for k, x in off._asdict().items()
                         if k not in ("dat_posteriors", "encodings")},
        "pieces": pieces,
    }


@pytest.fixture(scope="module")
def jgold(inputs, tmp_path_factory):  # noqa: F811
    return golden(tmp_path_factory, "model_infer", lambda: _jax_golden(*inputs))


@pytest.fixture(scope="module")
def model():
    m = STYLER(default_config().replace(src_buckets=(L,), mel_buckets=(M,)))
    load_flax_tree(m, *load_acoustic_npz(ASSET))
    return m.eval()


@pytest.fixture(scope="module")
def targs(inputs):  # noqa: F811
    src, mel, p, e, src_len, mel_len, spk = (torch.from_numpy(np.asarray(x)) for x in inputs)
    return src, mel, mel, p, e, src_len, mel_len, M, spk


def _close(got, want):
    got = got.detach().numpy().astype(np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= REL * scale, (np.abs(got - want).max(), scale)


@pytest.fixture(scope="module")
def encoded(model, targs):
    with torch.no_grad():
        return model.encode_style(*targs)


@pytest.mark.parametrize("key", ["t", "t_neck", "p_down", "s_down", "d", "s", "e", "n"])
def test_encode_style_encodings(encoded, jgold, key):
    _close(encoded[0][key], jgold["encode"][0][key])


def test_encode_style_mask_and_length(encoded, jgold, model, targs):
    _, src_mask, mel_len = encoded
    np.testing.assert_array_equal(src_mask.numpy(), jgold["encode"][1])
    np.testing.assert_array_equal(mel_len.numpy(), jgold["encode"][2])
    with torch.no_grad():
        full = model(*targs)
    np.testing.assert_array_equal(mel_len.numpy(), full.mel_len.numpy())


@pytest.fixture(scope="module")
def pieces(model, jgold):
    enc, src_mask, _ = jgold["encode"]
    t = {k: torch.from_numpy(v.copy()) for k, v in enc.items()}
    out = {}
    with torch.no_grad():
        for name, (sn, (dc, pc, ec)) in CASES.items():
            sn = sn if isinstance(sn, bool) else torch.from_numpy(sn)
            out[name] = model.style_modeling.predict_inference(
                *_mixed(t), torch.from_numpy(src_mask.copy()), M, sn, dc, pc, ec)
    return out


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("i", range(len(PIECES)), ids=PIECES)
def test_predict_inference(pieces, jgold, case, i):
    got, want = pieces[case][i], jgold["pieces"][case][i]
    if PIECES[i] == "mel_mask":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close(got, want)


def test_predict_inference_weights_select_the_speaker_stream(pieces):
    """A float weight of 1.0 is ``speaker_normalized=False`` for its row,
    0.0 is ``True``."""
    for row, case in ((0, "with_speaker"), (1, "normalized")):
        torch.testing.assert_close(pieces["per_row"][6][row], pieces[case][6][row],
                                   rtol=0, atol=0)


@pytest.fixture(scope="module")
def residual_off(model, targs):
    with torch.no_grad():
        return model(*targs, residual=False)


@pytest.mark.parametrize("field", ["mel", "mel_postnet", "mel_noisy", "mel_postnet_noisy",
                                   "log_d_prediction", "p_prediction", "e_prediction"])
def test_residual_off_heads(residual_off, jgold, field):
    _close(getattr(residual_off, field), jgold["residual_off"][field])


def test_residual_off_aliases_the_clean_decode(residual_off, model, targs, jgold):
    """The noisy slots are the clean tensors, and the clean decode is the
    one of the default (residual) forward."""
    assert residual_off.mel_postnet_noisy is residual_off.mel_postnet
    assert residual_off.mel_noisy is residual_off.mel
    np.testing.assert_array_equal(residual_off.mel_mask.numpy(), jgold["residual_off"]["mel_mask"])
    with torch.no_grad():
        on = model(*targs)
    torch.testing.assert_close(residual_off.mel_postnet, on.mel_postnet, atol=2e-4, rtol=1e-4)
