"""The STYLER acoustic model as nn.Modules (eval forward)."""

from styler_tpu_torch.models.styler import STYLER, StylerOutput  # noqa: F401
