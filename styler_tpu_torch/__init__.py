"""styler_tpu_torch — the PyTorch/CUDA port of styler_tpu for NVIDIA Hopper.

The JAX package ``styler_tpu`` beside it is the reference; this package
imports nothing of it (nor JAX) and keeps its own copies of what it
needs. It mirrors the reference's layout:

- ``core``      config, checkpoint reading, flax-tree -> torch weight
                conversion, device selection.
- ``textproc``  phoneme symbol set / cleaners / G2P (a copy).
- ``dsp``       mel front end, f0 tracking, feature quantizers.
- ``data``      wav reading; the training dataset and bucketed loader.
- ``ops``       masking, positions, length regulation, calibration,
                dropout with explicit generators, gradient reversal, the
                BiLSTM wrapper, and the hand-written CUDA kernels
                (``ops/resblock.py``, ``ops/lstm.py``; sources in
                ``csrc/``, built at first use by ``ops/build.py``).
- ``models``    the STYLER acoustic model as ``nn.Module``s.
- ``vocoder``   the iSTFTNet generator.
- ``synthesis`` ``load_synthesizer`` / ``Synthesizer.synthesize``.
- ``train``     losses, Noam Adam, train state, train / eval steps, the
                trainer (``python -m styler_tpu_torch.train``).

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
