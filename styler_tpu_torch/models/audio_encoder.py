"""Audio (style factor) encoder: 4 conv stacks, one mel calibration, and
the bottleneck BiLSTMs (counterpart of ``styler_tpu/models/audio_encoder.py``).

Input is the 674-channel concat [clean mel 80 | f0 one-hot 257 | energy
one-hot 257 | aug mel 80]. Per branch 3x [Conv1d k5 -> GroupNorm(C/16,
eps 1e-6) -> ReLU]; the four branch outputs (1152 channels) are
calibrated frame -> phoneme domain in one batched matmul; then 2-layer
BiLSTMs with necks d=80, p=64, e=64, r=64, all four run layer by layer
in one launch of kernel B (``ops/recurrent.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from styler_tpu_torch.models.transformer import Conv1d
from styler_tpu_torch.ops.recurrent import fused_bilstm_branches
from styler_tpu_torch.ops.regulate import mel_calibrate


class BiLSTM(nn.Module):
    """PyTorch-layout parameters of a multi-layer BiLSTM, named as the
    flax module names them (``l{layer}_{fwd|bwd}_{w_ih,w_hh,b_ih,b_hh}``)."""

    def __init__(self, input_dim: int, hidden: int, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        in_dim = input_dim
        for layer in range(num_layers):
            for d in ("fwd", "bwd"):
                for name, shape in (
                    ("w_ih", (4 * hidden, in_dim)),
                    ("w_hh", (4 * hidden, hidden)),
                    ("b_ih", (4 * hidden,)),
                    ("b_hh", (4 * hidden,)),
                ):
                    self.register_parameter(
                        f"l{layer}_{d}_{name}", nn.Parameter(torch.zeros(shape))
                    )
            in_dim = 2 * hidden

    def layer_params(self) -> List[dict]:
        return [
            {
                d: {n: getattr(self, f"l{layer}_{d}_{n}") for n in ("w_ih", "w_hh", "b_ih", "b_hh")}
                for d in ("fwd", "bwd")
            }
            for layer in range(self.num_layers)
        ]


class ConvBranch(nn.Module):
    """3x [Conv1d k5 SAME -> GroupNorm -> ReLU] (reference modules.py:103-160).
    The convs compute in ``compute_dtype``; the GroupNorm returns float32."""

    def __init__(self, in_dim: int, dim: int, chs_grp: int = 16, n_layers: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(f"conv_{i}", Conv1d(in_dim if i == 0 else dim, dim, 5, 2, compute_dtype))
            self.add_module(f"gn_{i}", nn.GroupNorm(dim // chs_grp, dim, eps=1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.transpose(1, 2)
        for i in range(self.n_layers):
            x = F.relu(getattr(self, f"gn_{i}")(getattr(self, f"conv_{i}")(x).float()))
        return x.transpose(1, 2)


class AudioEncoder(nn.Module):
    def __init__(self, n_mel_channels=80, dim_f0=257, dim_energy=257,
                 enc_dim_d=256, enc_dim_p=320, enc_dim_e=320, enc_dim_r=256,
                 neck_d=80, neck_p=64, neck_e=64, neck_r=64, chs_grp=16,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.split_in = (n_mel_channels, dim_f0, dim_energy, n_mel_channels)
        self.split_enc = (enc_dim_d, enc_dim_p, enc_dim_e, enc_dim_r)
        self.convs_d = ConvBranch(n_mel_channels, enc_dim_d, chs_grp, compute_dtype=compute_dtype)
        self.convs_p = ConvBranch(dim_f0, enc_dim_p, chs_grp, compute_dtype=compute_dtype)
        self.convs_e = ConvBranch(dim_energy, enc_dim_e, chs_grp, compute_dtype=compute_dtype)
        self.convs_r = ConvBranch(n_mel_channels, enc_dim_r, chs_grp, compute_dtype=compute_dtype)
        self.lstm_d = BiLSTM(enc_dim_d, neck_d)
        self.lstm_p = BiLSTM(enc_dim_p, neck_p)
        self.lstm_e = BiLSTM(enc_dim_e, neck_e)
        self.lstm_r = BiLSTM(enc_dim_r, neck_r)

    def forward(
        self, enc_cat: torch.Tensor, mel_len: torch.Tensor, seq_len: torch.Tensor, max_src: int
    ) -> Tuple[torch.Tensor, ...]:
        """enc_cat: [B, M, 674]; mel_len, seq_len: [B]. Returns the
        (duration, pitch, energy, noise) encodings, each [B, max_src, 2*neck]."""
        d_in, f0_in, e_in, r_in = torch.split(enc_cat, self.split_in, dim=-1)
        cat = torch.cat(
            [self.convs_d(d_in), self.convs_p(f0_in), self.convs_e(e_in), self.convs_r(r_in)],
            dim=-1,
        )  # [B, M, 1152]
        cat = mel_calibrate(cat, mel_len, seq_len, max_src)  # [B, S, 1152]
        xs = list(torch.split(cat, self.split_enc, dim=-1))
        lstms = (self.lstm_d, self.lstm_p, self.lstm_e, self.lstm_r)
        return tuple(fused_bilstm_branches([m.layer_params() for m in lstms], xs, seq_len))
