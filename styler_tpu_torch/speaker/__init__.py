"""Speaker embedders: the DeepSpeaker ResCNN, the trained encoder and their
fbank features (counterpart of ``styler_tpu/speaker``; speaker training and
its ``CosineClassifier`` are a later slice)."""

from styler_tpu_torch.speaker.encoder import SpeakerEncoder  # noqa: F401
from styler_tpu_torch.speaker.features import (  # noqa: F401
    NUM_FBANKS,
    NUM_FRAMES,
    fbank_features,
    normalize_frames,
    speaker_features_from_audio,
    trim_silence,
)
from styler_tpu_torch.speaker.rescnn import ResCNN, import_deepspeaker_h5  # noqa: F401
