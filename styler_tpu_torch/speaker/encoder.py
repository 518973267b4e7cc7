"""The trained speaker encoder (inference), counterpart of
``styler_tpu/speaker/encoder.py:SpeakerEncoder``.

A small member of the DeepSpeaker ResCNN family (~1.6 M parameters): 3
stages of [conv 5x5 stride 2 -> BN -> clipped-ReLU -> 2 identity blocks]
with 32/64/128 filters, temporal mean pool, Dense(512), L2-normalize. Its
committed weights are ``assets/speaker/encoder_gen.npz``. The JAX
package's ``_ConvResStage`` / ``_IdentityBlock`` carry the same leaf
names as ``rescnn.py``'s blocks, so the port keeps one implementation of
them. Training (``CosineClassifier``, ``cli/train_speaker.py``) is a later
slice of the port.
"""

from __future__ import annotations

from typing import Tuple

from styler_tpu_torch.speaker.rescnn import ResCNN


class SpeakerEncoder(ResCNN):
    """[B, 1, T, 64] fbank crops -> [B, embed_dim] L2-normalized."""

    def __init__(self, filters: Tuple[int, ...] = (32, 64, 128), embed_dim: int = 512,
                 n_blocks: int = 2):
        super().__init__(filters, n_blocks, embed_dim)
