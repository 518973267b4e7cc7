"""Synthesis CLI of the port (counterpart of ``cli/synthesize.py``).

    python -m styler_tpu_torch.cli.synthesize --ref_name p225_001 \\
        --ref_audio_dir refs/ --ref_tg_dir refs/ [--sentence "..."] [--device cpu]

Flags of ``cli/synthesize.py``: --ckpt, --ref_name, --speaker_id,
--noisy_input, --inspection, --cont --r1 --r2, the three control knobs,
--version, --sentence, --outdir, --batch, the bucket overrides, --vocoder,
--bf16; plus --device. Writes per sentence the clean and the ``_noisy`` wav and
the ``_mel.npy`` under the JAX CLI's file names; ``--inspection`` one wav
per ablation row; ``--cont`` the two references' wav copies and each
combination's wav and mel npy. The JAX CLI's PNG overlays are not written
(ROADMAP.md, Queue 1 [12]). ``--ckpt`` takes every acoustic form of
``synthesis.py:load_synthesizer`` (a ``.npz`` asset, the trainer's
``step_<N>.pt`` or its directory, a reference ``checkpoint_<step>.pth.tar``,
``random``); ``--bf16`` runs the acoustic model in bfloat16 mixed
precision. ``--vocoder MelGAN|WaveGlow`` and an orbax ``--ckpt`` directory
raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

from styler_tpu_torch.cli import add_model_flags, config_from_args, refuse_unported


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        prog="python -m styler_tpu_torch.cli.synthesize",
        description="Synthesize sentences in the style of a reference wav.",
        epilog="The PNG feature overlays of cli/synthesize.py are not written by the "
               "port yet (ROADMAP.md, Queue 1 [12]).",
    )
    add_model_flags(parser)
    parser.add_argument("--ref_name", type=str, default=None)
    parser.add_argument("--speaker_id", type=str, default=None)
    parser.add_argument("--noisy_input", action="store_true")
    parser.add_argument("--inspection", action="store_true")
    parser.add_argument("--cont", action="store_true")
    parser.add_argument("--r1", type=str, default=None)
    parser.add_argument("--r2", type=str, default=None)
    parser.add_argument("--duration_control", type=float, default=1.0)
    parser.add_argument("--pitch_control", type=float, default=1.0)
    parser.add_argument("--energy_control", type=float, default=1.0)
    parser.add_argument("--sentence", type=str, default=None,
                        help="synthesize a single sentence instead of the built-in list")
    parser.add_argument("--outdir", type=str, default=None)
    parser.add_argument("--batch", action="store_true",
                        help="synthesize all sentences in one batched forward")
    args = parser.parse_args(argv)
    if not (args.ref_name or (args.cont and args.r1 and args.r2)):
        parser.error("need --ref_name, or --cont with --r1/--r2")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    refuse_unported(args)

    import numpy as np

    from styler_tpu_torch.data.audio_io import audiowrite
    from styler_tpu_torch.data.sentences import sentences
    from styler_tpu_torch.synthesis import load_reference, load_synthesizer

    cfg = config_from_args(args)
    synth = load_synthesizer(cfg, args.ckpt, args.vocoder_ckpt, vocoder_arch=args.vocoder,
                             device=args.device)
    outdir = args.outdir or cfg.test_path()
    os.makedirs(outdir, exist_ok=True)

    def load_ref(name):
        return load_reference(cfg, synth.frontend, name, args.speaker_id, args.noisy_input)

    def write(stem, r):
        audiowrite(r["wav"], cfg.sampling_rate, os.path.join(outdir, stem + ".wav"))
        audiowrite(r["wav_noisy"], cfg.sampling_rate, os.path.join(outdir, stem + "_noisy.wav"))
        np.save(os.path.join(outdir, stem + "_mel.npy"), r["mel"])

    def stem_of(i, sentence):
        return f"{i}_{synth.config.vocoder}_{sentence[:10].replace(' ', '_')}"

    if args.cont:
        ref1, spk1 = load_ref(args.r1)
        ref2, spk2 = load_ref(args.r2)
        s1 = args.sentence or sentences[0]
        s2 = args.sentence or sentences[1]
        t0 = time.perf_counter()
        results = synth.mix_and_match((s1, s2), (ref1, ref2), (spk1, spk2))
        print(f"mix_and_match 2^5 combos in {time.perf_counter() - t0:.2f}s")
        # the reference's inventory (synthesize.py:227-231, 277-279): a
        # control_r1_X_r2_Y dir with each reference's wav copy, then a wav
        # (and the mel npy) per combination
        outdir = os.path.join(outdir, f"control_r1_{args.r1}_r2_{args.r2}")
        os.makedirs(outdir, exist_ok=True)
        for name in (args.r1, args.r2):
            src_wav = os.path.join(cfg.ref_audio_dir, name + ".wav")
            if os.path.exists(src_wav):
                shutil.copy(src_wav, os.path.join(outdir, name + ".wav"))
        for comb, r in results.items():
            audiowrite(r["wav"], cfg.sampling_rate, os.path.join(outdir, f"{comb}.wav"))
            np.save(os.path.join(outdir, f"{comb}.npy"), r["mel"])
        return

    ref, speaker_embed = load_ref(args.ref_name)
    todo = [args.sentence] if args.sentence else sentences
    start_time = time.perf_counter()
    controls = dict(d_control=args.duration_control, p_control=args.pitch_control,
                    e_control=args.energy_control)

    if args.batch:
        # one card: no mesh
        results = synth.synthesize_batch(todo, [ref] * len(todo), [speaker_embed] * len(todo),
                                         **controls)
        for i, (sentence, r) in enumerate(zip(todo, results)):
            write(stem_of(i, sentence), r)
        dt = time.perf_counter() - start_time
        audio_sec = sum(r["mel_len"] for r in results) * cfg.hop_length / cfg.sampling_rate
        print(f"Batched {len(todo)} sentences: {audio_sec:.1f}s audio in "
              f"{dt:.2f}s (RTF {audio_sec / dt:.1f}x)")
        return
    for i, sentence in enumerate(todo):
        t0 = time.perf_counter()
        r = synth.synthesize(sentence, ref, speaker_embed, **controls)
        dt = time.perf_counter() - t0
        stem = stem_of(i, sentence)
        write(stem, r)
        audio_sec = r["mel_len"] * cfg.hop_length / cfg.sampling_rate
        print(f"[{i}] {audio_sec:.2f}s audio in {dt:.3f}s (RTF {audio_sec / dt:.1f}x): {sentence}")
        if args.inspection:
            # one wav per ablation row (reference synthesize.py:284-289, 341-344)
            for title, g in synth.inspect(sentence, ref, speaker_embed).items():
                audiowrite(g["wav"], cfg.sampling_rate,
                           os.path.join(outdir, f"{stem}_inspect_{title.replace('+', '')}.wav"))
    print(f"Synthesized {len(todo)} in {time.perf_counter() - start_time:.3f}s")


if __name__ == "__main__":
    sys.exit(main())
