"""styler_tpu_torch — the PyTorch/CUDA port of styler_tpu for NVIDIA Hopper.

The JAX package ``styler_tpu`` beside it is the reference; this package
imports nothing of it (nor JAX) and keeps its own copies of what it
needs. It mirrors the reference's layout:

- ``core``      config, checkpoint reading, flax-tree -> torch weight
                conversion, device selection.
- ``textproc``  phoneme symbol set / cleaners / G2P (a copy).
- ``dsp``       mel front end, f0 tracking, feature quantizers.
- ``ops``       masking, positions, length regulation, calibration, the
                BiLSTM wrapper, and the hand-written CUDA kernels
                (``ops/resblock.py``, ``ops/lstm.py``; sources in
                ``csrc/``, built at first use by ``ops/build.py``).
- ``models``    the STYLER acoustic model as ``nn.Module``s.
- ``vocoder``   the iSTFTNet generator.
- ``synthesis`` ``load_synthesizer`` / ``Synthesizer.synthesize``.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
