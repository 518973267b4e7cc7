"""Configuration, asset reading, weight conversion and device selection."""

from styler_tpu_torch.core.config import Config, bucket_for, default_config  # noqa: F401
