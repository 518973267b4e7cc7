"""STYLER losses (counterpart of ``styler_tpu/train/losses.py``; reference
loss.py:7-68), masked-mean formulation: every term is
sum(loss * valid) / sum(valid)."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def _masked_mean(err: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    valid = valid.to(err.dtype)
    # err may carry a trailing channel axis that valid broadcasts over:
    # the mean then runs over valid positions x 1, as in the reference
    return (err * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def masked_mse(pred, target, valid):
    return _masked_mean((pred - target) ** 2, valid)


def masked_mae(pred, target, valid):
    return _masked_mean(torch.abs(pred - target), valid)


def nll_loss(log_posterior: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``torch.nn.NLLLoss`` on log-softmax outputs: mean over the batch of
    -log_posterior[b, label_b]."""
    picked = torch.gather(log_posterior, -1, labels[:, None].to(torch.int64))[:, 0]
    return -picked.mean()


def dat_loss(posteriors: Tuple, labels: torch.Tensor) -> torch.Tensor:
    """Sum of NLL over the 3 augmentation classifiers (loss.py:46-48,65-67)."""
    d, p, e = posteriors
    return nll_loss(d, labels) + nll_loss(p, labels) + nll_loss(e, labels)


def styler_loss(
    out,
    mel_target: torch.Tensor,
    mel_aug: torch.Tensor,
    log_d_target: torch.Tensor,
    p_target: torch.Tensor,
    e_target: torch.Tensor,
    dat_posteriors_aug: Tuple,
    dat_weight: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total training loss (reference train.py:134-160).

    out: StylerOutput of the teacher-forced forward. dat_posteriors_aug:
    posteriors of the second (fully augmented) pass. Returns (total,
    components named as the reference's 10 log scalars).
    """
    src_valid = ~out.src_mask  # [B, L]
    mel_valid_1d = ~out.mel_mask  # [B, M]
    mel_valid = mel_valid_1d[..., None]  # [B, M, 1]

    mel_loss = masked_mse(out.mel, mel_target, mel_valid)
    mel_postnet_loss = masked_mse(out.mel_postnet, mel_target, mel_valid)
    mel_noisy_loss = masked_mse(out.mel_noisy, mel_aug, mel_valid)
    mel_postnet_noisy_loss = masked_mse(out.mel_postnet_noisy, mel_aug, mel_valid)

    d_loss = masked_mae(out.log_d_prediction, log_d_target, src_valid)
    f_loss = masked_mae(out.p_prediction, p_target, mel_valid_1d)
    e_loss = masked_mae(out.e_prediction, e_target, mel_valid_1d)

    batch = mel_target.shape[0]
    labels = torch.zeros(batch, dtype=torch.int64, device=mel_target.device)
    cl_clean = dat_loss(out.dat_posteriors, labels)
    cl_aug = dat_loss(dat_posteriors_aug, labels + 1)

    total = (
        mel_loss
        + mel_postnet_loss
        + mel_noisy_loss
        + mel_postnet_noisy_loss
        + d_loss
        + f_loss
        + e_loss
        + dat_weight * (cl_clean + cl_aug)
    )
    components = {
        "total": total,
        "mel": mel_loss,
        "mel_postnet": mel_postnet_loss,
        "mel_noisy": mel_noisy_loss,
        "mel_postnet_noisy": mel_postnet_noisy_loss,
        "duration": d_loss,
        "f0": f_loss,
        "energy": e_loss,
        "dat_clean": cl_clean,
        "dat_aug": cl_aug,
    }
    return total, components
