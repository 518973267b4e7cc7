"""FastSpeech-style FFT-block transformer stack
(counterpart of ``styler_tpu/models/transformer.py``).

Post-LN residual attention with key-side masking and output zeroing on
padded queries; position-wise conv FFN; sinusoid positions; the Tacotron2
PostNet. Layouts are channels-last [B, T, C]. LayerNorm eps is flax's
1e-6; the PostNet BatchNorm runs on its loaded running statistics with
eps 1e-5.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from styler_tpu_torch.ops.position import sinusoid_table

LN_EPS = 1e-6


def conv1d_cl(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Apply a channels-first Conv1d to a channels-last [B, T, C] tensor."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class _PositionTable(nn.Module):
    """Sinusoid tables cached per (rows, device)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model
        self._tables: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def table(self, n_position: int, device: torch.device) -> torch.Tensor:
        key = (n_position, device)
        if key not in self._tables:
            self._tables[key] = torch.from_numpy(
                sinusoid_table(n_position, self.d_model)
            ).to(device)
        return self._tables[key]


class MultiHeadAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int):
        super().__init__()
        self.n_head = n_head
        self.w_qs = nn.Linear(d_model, d_model)
        self.w_ks = nn.Linear(d_model, d_model)
        self.w_vs = nn.Linear(d_model, d_model)
        self.fc = nn.Linear(d_model, d_model)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor, key_pad: torch.Tensor) -> torch.Tensor:
        """x: [B, T, D]; key_pad: [B, T] True where the key is padding."""
        B, T, D = x.shape

        def heads(t):
            return t.reshape(B, T, self.n_head, D // self.n_head).transpose(1, 2)

        q, k, v = heads(self.w_qs(x)), heads(self.w_ks(x)), heads(self.w_vs(x))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=~key_pad[:, None, None, :]
        )
        out = self.fc(out.transpose(1, 2).reshape(B, T, D))
        return self.layer_norm(out + x)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, d_inner: int, kernel_sizes=(9, 1)):
        super().__init__()
        k1, k2 = kernel_sizes
        self.w_1 = nn.Conv1d(d_model, d_inner, k1, padding=(k1 - 1) // 2)
        self.w_2 = nn.Conv1d(d_inner, d_model, k2, padding=(k2 - 1) // 2)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv1d_cl(self.w_2, F.relu(conv1d_cl(self.w_1, x)))
        return self.layer_norm(out + x)


class FFTBlock(nn.Module):
    def __init__(self, d_model: int, d_inner: int, n_head: int, kernel_sizes=(9, 1)):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel_sizes)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        """pad_mask: [B, T] True at padding (keys masked, queries zeroed)."""
        pad = pad_mask[..., None]
        out = self.slf_attn(x, pad_mask).masked_fill(pad, 0.0)
        return self.pos_ffn(out).masked_fill(pad, 0.0)


class TextEncoder(nn.Module):
    """Phoneme embedding + sinusoid positions + FFT blocks
    (reference transformer/Models.py:33-84)."""

    def __init__(self, vocab_size, max_seq_len, d_model=256, n_layers=2,
                 n_head=4, d_inner=1024, kernel_sizes=(9, 1)):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.src_word_emb = nn.Parameter(torch.zeros(vocab_size, d_model))
        self.positions = _PositionTable(d_model)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", FFTBlock(d_model, d_inner, n_head, kernel_sizes))
        self.n_layers = n_layers

    def forward(self, src_seq: torch.Tensor, src_mask: torch.Tensor) -> torch.Tensor:
        # padding_idx=0: row 0 of the table reads as zero
        x = F.embedding(src_seq, self.src_word_emb)
        x = x.masked_fill((src_seq == 0)[..., None], 0.0)
        L = x.shape[1]
        pos = self.positions.table(max(self.max_seq_len + 1, L), x.device)
        x = x + pos[None, :L]
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, src_mask)
        return x


class MelDecoder(nn.Module):
    """FFT-block decoder over frame-domain encodings
    (reference transformer/Models.py:87-135)."""

    def __init__(self, max_seq_len, d_model=256, n_layers=4, n_head=4,
                 d_inner=1024, kernel_sizes=(9, 1)):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.positions = _PositionTable(d_model)
        for i in range(n_layers):
            self.add_module(f"layer_{i}", FFTBlock(d_model, d_inner, n_head, kernel_sizes))
        self.n_layers = n_layers

    def forward(self, x: torch.Tensor, mel_mask: torch.Tensor) -> torch.Tensor:
        T = x.shape[1]
        # the table has max_seq_len+1 rows; a longer frame axis gets its
        # own table (reference Models.py:120-122)
        pos = self.positions.table(max(self.max_seq_len + 1, T), x.device)
        x = x + pos[None, :T]
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, mel_mask)
        return x


class PostNet(nn.Module):
    """Tacotron2 PostNet (reference transformer/Layers.py:67-130):
    5x [Conv1d k5 -> BatchNorm (running stats) -> tanh (except last)]."""

    def __init__(self, n_mel_channels=80, embedding_dim=512, kernel_size=5, n_convolutions=5):
        super().__init__()
        self.n_convolutions = n_convolutions
        for i in range(n_convolutions):
            c_in = n_mel_channels if i == 0 else embedding_dim
            c_out = n_mel_channels if i == n_convolutions - 1 else embedding_dim
            self.add_module(
                f"conv_{i}", nn.Conv1d(c_in, c_out, kernel_size, padding=(kernel_size - 1) // 2)
            )
            self.add_module(f"bn_{i}", nn.BatchNorm1d(c_out, eps=1e-5))

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel.transpose(1, 2)
        for i in range(self.n_convolutions):
            x = getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(x))
            if i < self.n_convolutions - 1:
                x = torch.tanh(x)
        return x.transpose(1, 2)
