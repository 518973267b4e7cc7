"""The STYLER acoustic model as nn.Modules."""

from styler_tpu_torch.models.styler import STYLER, StylerOutput  # noqa: F401
