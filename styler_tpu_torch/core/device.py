"""Device selection for the port's entry points.

The entry points run on CUDA unless the caller asks for the CPU; with no
device given and no CUDA device present they raise instead of carrying on
on the CPU.

This is also where the port sets its float32 matmul precision. The
reference runs the acoustic model's precision-critical products (the mel
calibrator, ``ops/regulate.py``, and the LSTMs, ``ops/recurrent.py``) at
``Precision.HIGHEST``, i.e. true f32, so TF32 is switched off for both
cuBLAS matmuls and cuDNN convolutions. The bfloat16 acoustic model's
products accumulate in float32 as XLA's do, so cuBLAS may not reduce a
bfloat16 product's partial sums in reduced precision either. The switches
are process-wide.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a CUDA device); else as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: styler_tpu_torch runs on the GPU unless "
                "device='cpu' is passed explicitly"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
