"""Acoustic-model training: losses, optimizer, state, steps, trainer."""

from styler_tpu_torch.train.losses import (  # noqa: F401
    dat_loss,
    masked_mae,
    masked_mse,
    nll_loss,
    styler_loss,
)
from styler_tpu_torch.train.optimizer import (  # noqa: F401
    NoamAdam,
    clip_by_global_norm,
    noam_schedule,
)
from styler_tpu_torch.train.state import (  # noqa: F401
    TrainState,
    create_train_state,
    train_state_from_flax,
)
from styler_tpu_torch.train.step import (  # noqa: F401
    FORWARD_KEYS,
    compute_gradients,
    eval_step,
    train_step,
)
