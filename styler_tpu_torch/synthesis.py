"""Synthesis engine: text + reference audio -> mels and waveforms
(counterpart of ``styler_tpu/synthesis.py``: ``ReferenceFeatures``,
``extract_reference_features``, ``load_reference``, the ``Synthesizer`` and
the weight resolution of ``load_synthesizer``).

One request: text -> phoneme ids on the host; the STYLER eval forward
(text encoder, audio encoder with the BiLSTM recurrences in kernel B,
predictors, length regulator, one 2B decode + PostNet); one 2B vocoder
pass over the clean and noisy mels, HiFi-GAN or iSTFTNet, whose resblock
stages run kernel A (HiFi-GAN: its int8 form with
``STYLER_TPU_INT8_VOCODER=1``). The reference mel axis pads to its bucket;
the output mel axis is always the largest mel bucket. A batch of requests,
a long sentence's chunks, the inspection grid and mix-and-match run the
same modules over more rows: kernel B takes every row in one launch per
layer, kernel A every vocoder row as a grid row.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from styler_tpu_torch.core.checkpoint import (
    default_acoustic_asset,
    default_vocoder_asset,
    latest_step,
    load_acoustic_npz,
    load_reference_checkpoint,
    load_trained_checkpoint,
    load_vocoder_npz,
)
from styler_tpu_torch.core.config import Config, bucket_for
from styler_tpu_torch.core.convert import load_flax_tree, to_flax_tree
from styler_tpu_torch.core.device import resolve_device
from styler_tpu_torch.core.import_torch import load_reference_vocoder
from styler_tpu_torch.data.audio_io import read_wav_int
from styler_tpu_torch.data.textgrid import alignment_from_file
from styler_tpu_torch.data.vctk import SpeakerEmbedder
from styler_tpu_torch.dsp.features import energy_rescaling_np, f0_normalization_np
from styler_tpu_torch.dsp.mel import MelFrontend
from styler_tpu_torch.dsp.pitch import get_f0, get_f0_noisy
from styler_tpu_torch.models import STYLER
from styler_tpu_torch.textproc import G2p, text_to_sequence, to_phoneme_string
from styler_tpu_torch.vocoder import make_generator

_log = logging.getLogger("styler_tpu_torch.synthesis")

#: acoustic checkpoints in the reference's torch format (``checkpoint_<step>.pth.tar``)
_REFERENCE_SUFFIXES = (".pth.tar", ".pth", ".tar")


@dataclasses.dataclass
class ReferenceFeatures:
    """Frame-domain features of a style reference audio."""

    mel: np.ndarray  # [M, 80]
    f0_norm: np.ndarray  # [M]
    energy01: np.ndarray  # [M]
    mel_len: int


def extract_reference_features(
    wav: np.ndarray,
    config: Config,
    frontend: MelFrontend,
    duration: Optional[list] = None,
    noisy: bool = False,
) -> ReferenceFeatures:
    """Reference wav (int16-scaled float) -> model inputs
    (reference dataset.py:58-71 + synthesize.py:420-441)."""
    f0 = (get_f0_noisy if noisy else get_f0)(wav, config, duration)
    mel, energy = frontend(np.asarray(wav, dtype=np.float32) / config.max_wav_value)
    total = sum(duration) if duration is not None else mel.shape[1]
    mel = mel.astype(np.float32)[:, :total].T
    energy = energy.astype(np.float32)[:total]
    n = min(len(f0), mel.shape[0], len(energy))
    cap = config.mel_buckets[-1]
    if n > cap:
        _log.warning(
            "reference audio is %d mel frames; trimming to the largest "
            "mel bucket (%d frames, %.1f s) for style extraction",
            n, cap, cap * config.hop_length / config.sampling_rate,
        )
        n = cap
    return ReferenceFeatures(
        mel=mel[:n],
        f0_norm=f0_normalization_np(f0[:n]).astype(np.float32),
        energy01=energy_rescaling_np(
            energy[:n], config.energy_min, config.energy_max
        ).astype(np.float32),
        mel_len=n,
    )


def load_reference(
    config: Config,
    frontend: MelFrontend,
    name: str,
    speaker_id: Optional[str] = None,
    noisy: bool = False,
) -> Tuple[ReferenceFeatures, np.ndarray]:
    """Load a style reference by name (``styler_tpu/synthesis.py:856-899``):
    the wav from ``config.ref_audio_dir``, trimmed to the span of its MFA
    TextGrid in ``config.ref_tg_dir`` when one exists (whose durations then
    set the frames), plus the speaker embedding: the precomputed
    ``<preprocessed_path>/spker_embed/<dataset>-spker_embed-<spk>.npy``
    when it exists, else the trimmed wav embedded by ``SpeakerEmbedder``
    on ``frontend.device``. Shared by the synthesize CLI and the server."""
    wav_path = os.path.join(config.ref_audio_dir, name + ".wav")
    tg_path = os.path.join(config.ref_tg_dir, name + ".TextGrid")
    sr, wav = read_wav_int(wav_path)
    duration = None
    if os.path.exists(tg_path):
        _, duration, start, end = alignment_from_file(
            tg_path, config.sampling_rate, config.hop_length
        )
        wav = wav[int(config.sampling_rate * start): int(config.sampling_rate * end)]
    ref = extract_reference_features(
        wav.astype(np.float32), config, frontend, duration, noisy
    )
    spk = speaker_id or name.split("_")[0]
    spk_path = os.path.join(
        config.preprocessed_path, "spker_embed", f"{config.dataset}-spker_embed-{spk}.npy"
    )
    if os.path.exists(spk_path):
        speaker_embed = np.load(spk_path)
    else:
        speaker_embed = SpeakerEmbedder(config, device=frontend.device).embed_wav(
            wav.astype(np.float32) / config.max_wav_value
        )
    return ref, np.asarray(speaker_embed, dtype=np.float32)


class Synthesizer:
    """The STYLER acoustic model and a HiFi-GAN or iSTFTNet vocoder
    (``config.vocoder``) on one device (CUDA unless ``device="cpu"``).

    Entry points, each the counterpart of the JAX ``Synthesizer``'s method
    of the same name with the same result keys: ``synthesize`` (sentences
    past the largest src bucket are cut at pauses and synthesized as one
    batch of chunks), ``synthesize_batch``, ``inspect`` (the ten-row
    style-factor ablation grid), ``mix_and_match`` (the 2^5 source
    combinations of two references) and ``warmup``. Each is one eager pass
    over the batch: one forward and one vocoder call, whatever the row
    count; on the card the vocoder's batch rows are grid rows of kernel A.

    ``STYLER_TPU_INT8_VOCODER=1``, read once here as the JAX package does,
    runs HiFi-GAN's resblock stages in kernel A's int8 form (approximate;
    ignored for iSTFTNet); ``int8_vocoder`` given as a bool overrides it
    (a serving bundle records its vocoder form)."""

    def __init__(self, config: Config, params: dict, batch_stats: dict,
                 vocoder_params: dict, device=None, int8_vocoder: Optional[bool] = None):
        self.config = config
        self.device = resolve_device(device)
        if int8_vocoder is None:
            int8_vocoder = os.environ.get("STYLER_TPU_INT8_VOCODER", "0") == "1"
        self.int8_vocoder = int8_vocoder
        self.generator = make_generator(config.vocoder, torch.bfloat16,
                                        quantize=self.int8_vocoder)
        load_flax_tree(self.generator, vocoder_params)
        self.generator.to(self.device).eval()
        self.model = STYLER(config)
        load_flax_tree(self.model, params, batch_stats)
        self.model.to(self.device).eval()
        self.frontend = MelFrontend(config, self.device)
        self.g2p = G2p()

    def text_to_ids(self, sentence: str) -> np.ndarray:
        return self._ids_from_phonemes(to_phoneme_string(sentence, self.g2p))

    def _ids_from_phonemes(self, phoneme_str: str) -> np.ndarray:
        return np.asarray(
            text_to_sequence(phoneme_str, list(self.config.text_cleaners)),
            dtype=np.int32,
        )

    # ------------------------------------------------------------------
    # Long inputs: the batch paths clamp rows past the largest bucket; the
    # single-sentence path chunks a long sentence instead.
    # ------------------------------------------------------------------

    def _clamp_ids(self, ids: np.ndarray) -> np.ndarray:
        cap = self.config.src_buckets[-1]
        if len(ids) > cap:
            _log.warning(
                "sentence has %d phonemes > largest src bucket %d; "
                "truncating (use Synthesizer.synthesize for automatic "
                "chunking of long sentences)", len(ids), cap,
            )
            return ids[:cap]
        return ids

    def _clamp_ref(self, ref: ReferenceFeatures) -> ReferenceFeatures:
        cap = self.config.mel_buckets[-1]
        if ref.mel_len <= cap:
            return ref
        _log.warning(
            "reference has %d mel frames > largest mel bucket %d; trimming",
            ref.mel_len, cap,
        )
        return ReferenceFeatures(
            mel=ref.mel[:cap], f0_norm=ref.f0_norm[:cap],
            energy01=ref.energy01[:cap], mel_len=cap,
        )

    def _phoneme_chunks(self, phoneme_str: str) -> List[np.ndarray]:
        """A long sentence's phoneme string -> phoneme-id rows that each fit
        the largest src bucket, cut after the last ``sp`` (pause) token of
        each window where there is one (ids are 1:1 with the tokens)."""
        cap = self.config.src_buckets[-1]
        tokens = phoneme_str[1:-1].split(" ")
        chunks, start = [], 0
        while start < len(tokens):
            end = min(start + cap, len(tokens))
            if end < len(tokens):
                for j in range(end - 1, start, -1):
                    if tokens[j] == "sp":
                        end = j + 1
                        break
            chunks.append(self._ids_from_phonemes("{" + " ".join(tokens[start:end]) + "}"))
            start = end
        return chunks

    def _synthesize_long(self, phoneme_str, ref, speaker_embed, d_control, p_control,
                         e_control) -> Dict:
        """A sentence past the largest src bucket: its chunks in one
        ``synthesize_batch`` call, padded to the next power of two with
        one-token rows (so the batch sizes stay few), outputs concatenated
        in order."""
        ids_rows = self._phoneme_chunks(phoneme_str)
        k = len(ids_rows)
        _log.warning(
            "sentence exceeds the largest src bucket (%d phonemes); "
            "synthesizing as %d chunks and concatenating",
            self.config.src_buckets[-1], k,
        )
        B = 1 << (k - 1).bit_length()
        ids_rows = ids_rows + [ids_rows[0][:1]] * (B - k)
        parts = self.synthesize_batch(
            [None] * B, [ref] * B, [speaker_embed] * B,
            d_control=d_control, p_control=p_control, e_control=e_control,
            ids_rows=ids_rows,
        )[:k]
        out = {key: np.concatenate([p[key] for p in parts], axis=0)
               for key in ("mel", "mel_noisy", "wav", "wav_noisy", "f0", "energy")}
        out["mel_len"] = int(sum(p["mel_len"] for p in parts))
        out["chunks"] = k
        return out

    def _pack_rows(self, ids_rows, ref_rows, spk_rows):
        """Parallel (phoneme ids, ReferenceFeatures, speaker embedding) rows,
        each clamped to the largest bucket, padded into the bucketed
        (src_seq [B, L], src_len, mel [B, M_in, 80], f0_norm, energy01,
        mel_len, speaker_embed) tensors on ``self.device``."""
        cfg = self.config
        ids_rows = [self._clamp_ids(i) for i in ids_rows]
        ref_rows = [self._clamp_ref(r) for r in ref_rows]
        B = len(ids_rows)
        L = bucket_for(max(len(i) for i in ids_rows), cfg.src_buckets)
        M_in = bucket_for(max(r.mel_len for r in ref_rows), cfg.mel_buckets)
        src_seq = np.zeros((B, L), np.int64)
        src_len = np.ones(B, np.int64)
        mel = np.zeros((B, M_in, cfg.n_mel_channels), np.float32)
        f0 = np.zeros((B, M_in), np.float32)
        en = np.zeros((B, M_in), np.float32)
        mel_len = np.ones(B, np.int64)
        spk = np.zeros((B, len(np.ravel(spk_rows[0]))), np.float32)
        for i, (ids, r, s) in enumerate(zip(ids_rows, ref_rows, spk_rows)):
            src_seq[i, : len(ids)] = ids
            src_len[i] = len(ids)
            mel[i, : r.mel_len] = r.mel[: r.mel_len]
            f0[i, : r.mel_len] = r.f0_norm[: r.mel_len]
            en[i, : r.mel_len] = r.energy01[: r.mel_len]
            mel_len[i] = r.mel_len
            spk[i] = np.ravel(s)
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in (src_seq, src_len, mel, f0, en, mel_len, spk))

    # ------------------------------------------------------------------

    @torch.no_grad()
    def _forward(self, src_seq, src_len, mel, f0_norm, energy01, mel_len,
                 speaker_embed, d_control, p_control, e_control, max_mel_len):
        """The device program of one request or batch: style encode,
        prediction, the dual decode and one 2B-row vocoder pass. Returns
        (model output, clean wav [B, max_mel_len * hop], noisy wav). The
        controls are floats or 0-d float32 tensors on the device
        (``models/style_modeling.py``); it reads nothing back to the host,
        so ``core/export.py`` captures it whole in a CUDA graph."""
        out = self.model(
            src_seq, mel, mel, f0_norm, energy01, src_len, mel_len,
            max_mel_len, speaker_embed, d_control, p_control, e_control,
        )
        # one 2B vocoder pass for the clean and the noisy mel
        B = out.mel_postnet.shape[0]
        wavs = self.generator(torch.cat([out.mel_postnet, out.mel_postnet_noisy], dim=0))
        return out, wavs[:B], wavs[B:]

    @torch.no_grad()
    def _encode(self, src_seq, src_len, mel, f0_norm, energy01, mel_len,
                speaker_embed, d_control, p_control, e_control, max_mel_len):
        """Style modeling only (no decode, no vocoder): the encodings of the
        inspection grid and of mix-and-match, which decode mixed rows of
        their own. Returns (encodings, src_mask, predicted mel_len)."""
        return self.model.encode_style(
            src_seq, mel, mel, f0_norm, energy01, src_len, mel_len, max_mel_len,
            speaker_embed, d_control, p_control, e_control,
        )

    @torch.no_grad()
    def warmup(self, batches=(1,)) -> int:
        """One forward for every (batch, src bucket, mel bucket), each
        ended by a host read of one sample, so that every kernel is built
        and every allocation made before the first request; then the
        reference front end at 256 and 1024 frames. Returns the number of
        forwards."""
        cfg = self.config
        dev = self.device
        n = 0
        for B in batches:
            for L in cfg.src_buckets:
                for M in cfg.mel_buckets:
                    _, wav, _ = self._forward(
                        torch.zeros((B, L), dtype=torch.int64, device=dev),
                        torch.ones(B, dtype=torch.int64, device=dev),
                        torch.zeros((B, M, cfg.n_mel_channels), device=dev),
                        torch.zeros((B, M), device=dev),
                        torch.zeros((B, M), device=dev),
                        torch.ones(B, dtype=torch.int64, device=dev),
                        torch.zeros((B, cfg.speaker_embed_dim), device=dev),
                        1.0, 1.0, 1.0,
                        cfg.mel_buckets[-1],
                    )
                    float(wav[0, 0])
                    n += 1
        for F in (256, 1024):
            self.frontend(np.zeros((F - 1) * cfg.hop_length, np.float32))
        return n

    @torch.no_grad()
    def synthesize(
        self,
        sentence: str,
        ref: ReferenceFeatures,
        speaker_embed: np.ndarray,
        d_control: float = 1.0,
        p_control: float = 1.0,
        e_control: float = 1.0,
    ) -> Dict:
        """One sentence with one reference -> mels + waveforms + predictions
        (the same keys as the reference's ``synthesize``).

        A sentence past the largest src bucket is synthesized in chunks cut
        at pauses and concatenated: that result has no ``encodings``,
        ``src_mask`` or ``duration`` and adds ``chunks``."""
        cfg = self.config
        phoneme_str = to_phoneme_string(sentence, self.g2p)
        ids = self._ids_from_phonemes(phoneme_str)
        if len(ids) > cfg.src_buckets[-1]:
            return self._synthesize_long(
                phoneme_str, ref, speaker_embed, d_control, p_control, e_control,
            )
        out, wav_clean, wav_noisy = self._forward(
            *self._pack_rows([ids], [ref], [speaker_embed]),
            float(d_control), float(p_control), float(e_control),
            cfg.mel_buckets[-1],
        )
        mel_len = int(out.mel_len[0])
        n_samples = mel_len * cfg.hop_length
        return {
            "mel": out.mel_postnet[0, :mel_len].cpu().numpy(),
            "mel_noisy": out.mel_postnet_noisy[0, :mel_len].cpu().numpy(),
            "wav": wav_clean[0, :n_samples].cpu().numpy(),
            "wav_noisy": wav_noisy[0, :n_samples].cpu().numpy(),
            "f0": out.p_prediction[0, :mel_len].cpu().numpy(),
            "energy": out.e_prediction[0, :mel_len].cpu().numpy(),
            "duration": out.log_d_prediction[0].cpu().numpy(),
            "mel_len": mel_len,
            "encodings": out.encodings,
            "src_mask": out.src_mask.cpu().numpy(),
        }

    @torch.no_grad()
    def synthesize_batch(
        self,
        sentences: list,
        refs: list,
        speaker_embeds: list,
        mesh=None,
        d_control: float = 1.0,
        p_control: float = 1.0,
        e_control: float = 1.0,
        ids_rows: Optional[list] = None,
    ) -> list:
        """N (sentence, reference, speaker embedding) rows in one forward and
        one 2N-row vocoder pass. Returns one dict per row, the keys of
        ``synthesize`` without ``encodings``, ``src_mask`` and ``duration``,
        plus ``truncated``: whether the row's sentence or reference was
        clamped to the largest bucket. ``ids_rows`` takes precomputed
        phoneme-id rows in place of the sentences (the chunked path).
        ``mesh`` (data parallelism over devices) raises
        ``NotImplementedError``."""
        if mesh is not None:
            raise NotImplementedError(
                "synthesize_batch(mesh=...): data parallelism over devices is a later "
                "slice of the port (ROADMAP.md, Queue 1 [16])"
            )
        cfg = self.config
        n = len(sentences)
        assert len(refs) == n and len(speaker_embeds) == n
        ids = ids_rows if ids_rows is not None else [self.text_to_ids(s) for s in sentences]
        truncated = [
            len(i) > cfg.src_buckets[-1] or r.mel_len > cfg.mel_buckets[-1]
            for i, r in zip(ids, refs)
        ]
        out, wav_clean, wav_noisy = self._forward(
            *self._pack_rows(ids, refs, speaker_embeds),
            float(d_control), float(p_control), float(e_control),
            cfg.mel_buckets[-1],
        )
        host = {
            key: t.cpu().numpy() for key, t in (
                ("mel", out.mel_postnet), ("mel_noisy", out.mel_postnet_noisy),
                ("wav", wav_clean), ("wav_noisy", wav_noisy),
                ("f0", out.p_prediction), ("energy", out.e_prediction),
            )
        }
        mel_lens = out.mel_len.cpu().numpy()
        results = []
        for i in range(n):
            ml = int(mel_lens[i])
            ns = ml * cfg.hop_length
            row = {key: v[i, :ns] if key.startswith("wav") else v[i, :ml]
                   for key, v in host.items()}
            results.append({**row, "mel_len": ml, "truncated": truncated[i]})
        return results

    # ------------------------------------------------------------------
    # Mixed-encoding decode (shared by inspect and mix_and_match)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def _mix_core(self, t, p, e, d, s, n, src_mask, spk_w, noise_w, max_mel_len):
        """B pre-mixed rows -> predictions, one decode and one vocoder call.
        ``spk_w``: per-row weights [B] of the speaker stream in the pitch
        predictor's input; ``noise_w``: per-row weights [B] of the noise
        stream in the decoder's input.

        Returns (mel_postnet, wav, p_prediction, e_prediction, mel_mask)."""
        (text_f, pitch_emb, speaker_f, energy_emb, noise_f, _, p_pred, e_pred,
         mel_mask) = self.model.style_modeling.predict_inference(
            t, p, e, d, s, n, src_mask, max_mel_len, spk_w)
        style_out = (text_f + pitch_emb + speaker_f + energy_emb
                     + noise_w.to(noise_f.dtype)[:, None, None] * noise_f)
        _, mel_postnet = self.model.decode(style_out, mel_mask)
        return mel_postnet, self.generator(mel_postnet), p_pred, e_pred, mel_mask

    def _compress(self, mel_postnet, wav, p_pred, e_pred, n):
        """Trim to ``n`` frames on the device and shrink what the host
        fetches: the wav as int16 (``round(clip(wav, -1, 1) * 32767)``,
        half to even, the quantisation a 16-bit wav file applies), the mel,
        f0 and energy as float16."""
        wav_i16 = torch.round(
            torch.clamp(wav[:, : n * self.config.hop_length], -1.0, 1.0) * 32767.0
        ).to(torch.int16)
        return (
            mel_postnet[:, :n].to(torch.float16),
            wav_i16,
            p_pred[:, :n].to(torch.float16),
            e_pred[:, :n].to(torch.float16),
        )

    def _unpack_results(self, titles, mel_postnet, wav, p_pred, e_pred, mel_lens):
        """Compressed outputs [B, ...] -> one float32 host dict per title."""
        mel_postnet, p_pred, e_pred = (x.cpu().numpy().astype(np.float32)
                                       for x in (mel_postnet, p_pred, e_pred))
        wav = wav.cpu().numpy().astype(np.float32) / 32767.0
        mel_lens = mel_lens.cpu().numpy()
        out = {}
        for i, title in enumerate(titles):
            ml = int(mel_lens[i])
            out[title] = {
                "mel": mel_postnet[i, :ml],
                "wav": wav[i, : ml * self.config.hop_length],
                "f0": p_pred[i, :ml],
                "energy": e_pred[i, :ml],
                "mel_len": ml,
            }
        return out

    def _mix_results(self, titles, mel_postnet, wav, p_pred, e_pred, mel_mask):
        """Uncompressed outputs [B, ...] -> host dicts, trimmed to the
        smallest mel bucket that holds every row (one host read of the
        mask picks it)."""
        mel_lens = (~mel_mask).sum(-1)
        n = bucket_for(int(mel_lens.max()), self.config.mel_buckets)
        return self._unpack_results(
            titles, *self._compress(mel_postnet, wav, p_pred, e_pred, n), mel_lens
        )

    # ------------------------------------------------------------------
    # Inspection: style-factor ablations (reference synthesize.py:282-341)
    # ------------------------------------------------------------------

    # (title, pitch source: "sp"|"norm"|None, +energy, +duration,
    #  speaker->pitch weight, noise weight), in the reference's title order
    _INSPECT_COMBOS = (
        ("T+D+P+E+S+N", "sp", 1, 1, 1.0, 1.0),
        ("T+D+P+E+N", "norm", 1, 1, 0.0, 1.0),
        ("T+D+P+N", "norm", 0, 1, 0.0, 1.0),
        ("T+D+N", None, 0, 1, 0.0, 1.0),
        ("T+N", None, 0, 0, 0.0, 1.0),
        ("T", None, 0, 0, 0.0, 0.0),
        ("T+D", None, 0, 1, 0.0, 0.0),
        ("T+D+P", "norm", 0, 1, 0.0, 0.0),
        ("T+D+P+E", "norm", 1, 1, 0.0, 0.0),
        ("T+D+P+E+S", "sp", 1, 1, 1.0, 0.0),
    )

    @torch.no_grad()
    def _inspect_rows(self, t, t_neck, d, s, e, n, p_down, s_down, src_mask, max_mel_len):
        """The ten ablation rows from one encoding ([1, L, ...] inputs)
        through the mixed decode ([10, ...] outputs)."""
        pitch_up = self.model.style_modeling.pitch_linear
        p_sp = pitch_up(p_down + s_down)
        p_no = pitch_up(p_down)
        rows_p, rows_e, rows_d, spk_w, noise_w = [], [], [], [], []
        for (_, psrc, add_e, add_d, sw, nw) in self._INSPECT_COMBOS:
            rows_p.append({"sp": t_neck + p_sp, "norm": t_neck + p_no, None: t_neck}[psrc])
            rows_e.append(t_neck + e if add_e else t_neck)
            rows_d.append(t_neck + d if add_d else t_neck)
            spk_w.append(sw)
            noise_w.append(nw)
        B = len(self._INSPECT_COMBOS)
        weights = torch.tensor([spk_w, noise_w], dtype=torch.float32).to(t.device)

        def tile(x):
            return x.expand(B, *x.shape[1:])

        return self._mix_core(
            tile(t), torch.cat(rows_p), torch.cat(rows_e), torch.cat(rows_d),
            tile(s), tile(n), tile(src_mask), weights[0], weights[1], max_mel_len,
        )

    @torch.no_grad()
    def inspect(self, sentence: str, ref: ReferenceFeatures, speaker_embed) -> Dict[str, Dict]:
        """Ablation grid T, T+D, T+D+P, ..., T+D+P+E+S+N (the reference's
        infer_inspection titles): one encode, then one 10-row decode and
        vocoder pass at the largest mel bucket (the duration-ablated rows T
        and T+N predict from t_neck alone, so the base row's length does
        not bound theirs). Values went through float16, the wav through
        int16."""
        M = self.config.mel_buckets[-1]
        ids = self.text_to_ids(sentence)
        enc, src_mask, _ = self._encode(
            *self._pack_rows([ids], [ref], [speaker_embed]), 1.0, 1.0, 1.0, M
        )
        outs = self._inspect_rows(
            enc["t"], enc["t_neck"], enc["d"], enc["s"], enc["e"], enc["n"],
            enc["p_down"], enc["s_down"], src_mask, M,
        )
        return self._mix_results([c[0] for c in self._INSPECT_COMBOS], *outs)

    # ------------------------------------------------------------------
    # Controllability: 2^5 mix-and-match (reference synthesize.py:208-279)
    # ------------------------------------------------------------------

    # comb "abcde" (bit 4 first): a text (with noise and masks), b
    # duration, c pitch, d energy, e speaker; row (text a, ref r) = 2a + r
    _COMB_BITS = np.array([[(comb >> (4 - i)) & 1 for i in range(5)] for comb in range(32)])
    _COMB_ROWS = 2 * _COMB_BITS[:, :1] + _COMB_BITS  # [32, 5]: text row, d, p, e, s rows

    @torch.no_grad()
    def _comb_rows(self, t4, t_neck4, n4, d4, p_down4, e4, s4, s_down4, src_mask4, max_mel_len):
        """The 32 combinations gathered from the 4 base rows ((text, ref) =
        (0,0), (0,1), (1,0), (1,1)), the mixed decode, and the compression
        at ``max_mel_len``: every combination's duration input is some base
        row's, so none is longer than the longest base row."""
        rows = torch.from_numpy(self._COMB_ROWS.T.copy()).to(t4.device)
        a, b, c, d, e = rows
        TN = t_neck4[a]
        p_tgt = self.model.style_modeling.pitch_linear(p_down4[c] + s_down4[e])
        ones = torch.ones(32, device=t4.device)
        mel_postnet, wav, p_pred, e_pred, mel_mask = self._mix_core(
            t4[a], TN + p_tgt, TN + e4[d], TN + d4[b], s4[e], n4[a], src_mask4[a],
            ones, 0.0 * ones, max_mel_len,
        )
        return (*self._compress(mel_postnet, wav, p_pred, e_pred, max_mel_len),
                (~mel_mask).sum(-1))

    @torch.no_grad()
    def mix_and_match(
        self,
        sentence_by_ref: Tuple[str, str],
        refs: Tuple[ReferenceFeatures, ReferenceFeatures],
        speaker_embeds: Tuple[np.ndarray, np.ndarray],
    ) -> Dict[str, Dict]:
        """All 2^5 (text, duration, pitch, energy, speaker) source
        combinations, titled ``f"{comb:05b}"``: bit a selects the text (and
        with it the noise stream and the masks), b the duration, c the
        pitch, d the energy, e the speaker; 0 = the first reference, 1 =
        the second (the reference's create_enc_comb). One 4-row encode and
        one 32-row decode and vocoder pass; values went through float16,
        the wav through int16."""
        titles, outs = self._mix_device_outs(sentence_by_ref, refs, speaker_embeds)
        return self._unpack_results(titles, *outs)

    def _mix_device_outs(self, sentence_by_ref, refs, speaker_embeds) -> Tuple[list, tuple]:
        """``mix_and_match`` up to the host fetch: (titles, compressed
        device outputs and mel lengths)."""
        cfg = self.config
        ids = [self.text_to_ids(s) for s in sentence_by_ref]
        pairs = ((0, 0), (0, 1), (1, 0), (1, 1))  # (text, ref) of the base rows
        enc, src_mask, base_mel_len = self._encode(
            *self._pack_rows([ids[ti] for ti, _ in pairs], [refs[ri] for _, ri in pairs],
                             [speaker_embeds[ri] for _, ri in pairs]),
            1.0, 1.0, 1.0, cfg.mel_buckets[-1],
        )
        # the longest combination is the longest base row: decode at its
        # bucket (one host read), not at the largest
        M_comb = bucket_for(int(base_mel_len.max()), cfg.mel_buckets)
        outs = self._comb_rows(
            enc["t"], enc["t_neck"], enc["n"], enc["d"], enc["p_down"],
            enc["e"], enc["s"], enc["s_down"], src_mask, M_comb,
        )
        return [f"{comb:05b}" for comb in range(32)], outs


def _random_vocoder(config: Config) -> dict:
    """Flax-style params of a generator drawn from an explicit seeded
    ``torch.Generator``: N(0, 0.01) kernels, zero biases (the JAX package's
    ``ConvTranspose1dTorch`` init; its ``nn.Conv`` leaves use lecun-normal
    from a ``jax.random`` key, which no torch generator reproduces, so the
    weights differ from the JAX package's ``"random"`` ones either way)."""
    gen = torch.Generator().manual_seed(config.seed)
    module = make_generator(config.vocoder)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith(("b1", "b2", "bias")):
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.01)
    return to_flax_tree(module)[0]


def _random_acoustic(config: Config) -> Tuple[dict, dict]:
    """Flax-style (params, batch_stats) of a STYLER drawn by
    ``train/state.py:init_like_flax`` from an explicit seeded
    ``torch.Generator`` (``config.seed``): the same weights on every device
    (for one torch version: its random streams may change between
    releases). The JAX package's ``"random"`` weights come from flax's ``init`` with a
    ``jax.random`` key, which no torch generator reproduces, so only the
    distributions of the two agree."""
    from styler_tpu_torch.train.state import init_like_flax

    model = STYLER(config)
    init_like_flax(model, torch.Generator().manual_seed(config.seed))
    return to_flax_tree(model)


def _acoustic_weights(config: Config, ckpt_path: Optional[str]) -> Tuple[dict, dict]:
    """(params, batch_stats) of the acoustic weight form ``ckpt_path``
    names (``load_synthesizer``'s docstring)."""
    if ckpt_path is None:
        ckpt_path = default_acoustic_asset()
        if ckpt_path is None:
            raise FileNotFoundError("assets/acoustic/styler_gen.npz is missing")
    if ckpt_path == "random":
        return _random_acoustic(config)
    if not os.path.exists(ckpt_path):
        raise FileNotFoundError(f"acoustic checkpoint: {ckpt_path}")
    if ckpt_path.endswith(_REFERENCE_SUFFIXES):
        return load_reference_checkpoint(ckpt_path, config)
    if ckpt_path.endswith(".npz"):
        return load_acoustic_npz(ckpt_path)
    if os.path.isdir(ckpt_path) and latest_step(ckpt_path) is None:
        if any(d.isdigit() for d in os.listdir(ckpt_path)):
            raise NotImplementedError(
                f"acoustic checkpoint {ckpt_path!r}: an orbax step directory of the JAX "
                "package; orbax imports jax and the card has no tensorstore, so the port "
                "cannot read it (ROADMAP.md, Queue 1 [9], blocked)")
        raise NotImplementedError(f"acoustic checkpoint {ckpt_path!r}: a directory with no "
                                  "step_<N>.pt checkpoint of the port's trainer")
    if os.path.isdir(ckpt_path) or ckpt_path.endswith(".pt"):
        return load_trained_checkpoint(ckpt_path, config)[:2]
    raise ValueError(f"acoustic checkpoint {ckpt_path!r}: not a .npz asset, a step_<N>.pt "
                     "or its directory, or a reference .pth.tar")


def load_synthesizer(
    config: Config,
    ckpt_path: Optional[str] = None,
    vocoder_path: Optional[str] = None,
    vocoder_arch: Optional[str] = None,
    device=None,
) -> Synthesizer:
    """Build a Synthesizer on ``device`` (CUDA unless ``device="cpu"``;
    with no CUDA device and no device given this raises, with no CPU
    fallback). ``config.compute_dtype="bfloat16"`` runs the acoustic
    model in the JAX package's mixed precision.

    Acoustic weights (``ckpt_path``):

    - ``None``: the committed trained asset (``assets/acoustic/styler_gen.npz``);
    - a ``.npz`` asset (``core/checkpoint.py:save_acoustic_npz``);
    - the port's trainer's ``step_<N>.pt``, or its checkpoint directory,
      resolved to the latest step (the JAX package reads an orbax step
      directory there); only the ``"model"`` state dict is read;
    - the reference's ``checkpoint_<step>.pth.tar`` (``.pth``, ``.tar``),
      through ``core/import_torch.py:import_styler_state``;
    - ``"random"``: weights drawn from a seeded ``torch.Generator``
      (``config.seed``), the same on every device; they cannot equal flax's
      random init, which draws from a ``jax.random`` key.

    An orbax directory, or a directory without a ``step_<N>.pt``, raises
    ``NotImplementedError``.

    Vocoder (resolution rules 1-3 of the JAX ``load_synthesizer``), for
    ``vocoder_arch`` if given, else ``config.vocoder``:

    1. an explicit ``vocoder_path``: a ``.npz`` asset loads for either
       arch; a reference ``.pth.tar`` loads for HiFi-GAN
       (``core/import_torch.py``, weight norm folded); an orbax directory
       raises (orbax imports jax; blocked, ROADMAP.md Queue 1 [9]);
    2. no path: the committed trained asset of the arch; with neither a
       path nor an arch given, the arch is promoted to the trained
       iSTFTNet, as the JAX package does when it serves its own weights,
       except for a reference ``.pth.tar`` acoustic checkpoint, which keeps
       ``config.vocoder`` (HiFi-GAN by default) for parity with the
       published model;
    3. ``vocoder_path="random"``: a generator drawn from a seeded
       ``torch.Generator`` (``config.seed``). It cannot equal flax's
       random init, which draws from a ``jax.random`` key.
    """
    device = resolve_device(device)
    from_reference = bool(ckpt_path) and ckpt_path.endswith(_REFERENCE_SUFFIXES)
    if vocoder_arch:
        config = config.replace(vocoder=vocoder_arch)
    elif vocoder_path is None and not from_reference:
        config = config.replace(vocoder="iSTFTNet")
    params, batch_stats = _acoustic_weights(config, ckpt_path)

    if vocoder_path == "random":
        vocoder_params = _random_vocoder(config)
    elif vocoder_path is None:
        asset = default_vocoder_asset(config.vocoder)
        if asset is None:
            raise FileNotFoundError(f"no committed trained {config.vocoder} asset in assets/vocoder/")
        vocoder_params = load_vocoder_npz(asset)
    elif not os.path.exists(vocoder_path):
        raise FileNotFoundError(f"vocoder checkpoint: {vocoder_path}")
    elif os.path.isdir(vocoder_path):
        raise NotImplementedError(
            f"vocoder checkpoint {vocoder_path!r}: an orbax directory; orbax imports jax and "
            "the card has no tensorstore, so the port cannot read it (ROADMAP.md, Queue 1 [9], "
            "blocked)")
    elif vocoder_path.endswith(".npz"):
        vocoder_params = load_vocoder_npz(vocoder_path)
    else:
        vocoder_params = load_reference_vocoder(vocoder_path, config.vocoder)
    return Synthesizer(config, params, batch_stats, vocoder_params, device)
