"""FastSpeech-style FFT-block transformer stack
(counterpart of ``styler_tpu/models/transformer.py``).

Post-LN residual attention with key-side masking and output zeroing on
padded queries; position-wise conv FFN; sinusoid positions; the Tacotron2
PostNet. Layouts are channels-last [B, T, C]. LayerNorm eps is flax's
1e-6; the PostNet BatchNorm (eps 1e-5) runs on its running statistics in
eval mode and on batch statistics in train mode, updating the running
ones as flax does. Every forward takes a ``dropout`` generator; ``None``
means no dropout (``ops/dropout.py``).

``compute_dtype`` follows flax's ``dtype=`` at exactly the sites where the
JAX model passes it (``Linear`` / ``Conv1d`` below: the attention
projections, the FFN convs, the PostNet convs): the input, weight and
bias are cast to it and the output is in it, while the parameters stay
float32. A norm layer takes such an output and returns float32, as
flax's norms with float32 parameters do, and a residual sum of a
bfloat16 and a float32 term is float32. Attention on bfloat16 q, k, v is
``jax.nn.dot_product_attention``'s: logits and softmax in float32, the
probabilities rounded to bfloat16 for the value product.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from styler_tpu_torch.ops.dropout import dropout as _dropout
from styler_tpu_torch.ops.position import sinusoid_table

LN_EPS = 1e-6
#: the masked logit of jax.nn.dot_product_attention (-0.7 x float32 max)
_MASKED = -0.7 * torch.finfo(torch.float32).max


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``compute_dtype`` (flax ``nn.Dense(dtype=)``)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv1d(nn.Conv1d):
    """``nn.Conv1d`` computing in ``compute_dtype`` (flax ``nn.Conv(dtype=)``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, padding: int = 0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, padding=padding)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(x.to(dt), self.weight.to(dt), self.bias.to(dt))


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


def _attention_reduced(q, k, v, key_pad):
    """``jax.nn.dot_product_attention`` (its XLA form) on bfloat16 q, k, v
    [B, H, T, Dh]: logits in float32 from the bfloat16 operands, scaled and
    masked, the softmax in float32, the probabilities rounded to v's dtype
    and the value product in it."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    logits = logits.masked_fill(key_pad[:, None, None, :], _MASKED)
    return torch.matmul(torch.softmax(logits, dim=-1).to(v.dtype), v)


class MultiHeadAttention(nn.Module):
    def __init__(self, n_head: int, d_model: int, dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_head = n_head
        self.dropout = dropout
        self.w_qs = Linear(d_model, d_model, compute_dtype)
        self.w_ks = Linear(d_model, d_model, compute_dtype)
        self.w_vs = Linear(d_model, d_model, compute_dtype)
        self.fc = Linear(d_model, d_model, compute_dtype)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor, key_pad: torch.Tensor,
                dropout: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, T, D]; key_pad: [B, T] True where the key is padding."""
        B, T, D = x.shape

        def heads(t):
            return t.reshape(B, T, self.n_head, D // self.n_head).transpose(1, 2)

        q, k, v = heads(self.w_qs(x)), heads(self.w_ks(x)), heads(self.w_vs(x))
        if q.dtype == torch.float32:
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=~key_pad[:, None, None, :])
        else:
            out = _attention_reduced(q, k, v, key_pad)
        out = _dropout(self.fc(out.transpose(1, 2).reshape(B, T, D)), self.dropout, dropout)
        return self.layer_norm(out + x)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, d_inner: int, kernel_sizes=(9, 1), dropout: float = 0.1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        k1, k2 = kernel_sizes
        self.dropout = dropout
        self.w_1 = Conv1d(d_model, d_inner, k1, (k1 - 1) // 2, compute_dtype)
        self.w_2 = Conv1d(d_inner, d_model, k2, (k2 - 1) // 2, compute_dtype)
        self.layer_norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor, dropout: Optional[torch.Generator] = None) -> torch.Tensor:
        out = conv1d_cl(self.w_2, F.relu(conv1d_cl(self.w_1, x)))
        return self.layer_norm(_dropout(out, self.dropout, dropout) + x)


class FFTBlock(nn.Module):
    def __init__(self, d_model: int, d_inner: int, n_head: int, kernel_sizes=(9, 1),
                 dropout: float = 0.1, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.slf_attn = MultiHeadAttention(n_head, d_model, dropout, compute_dtype)
        self.pos_ffn = PositionwiseFeedForward(d_model, d_inner, kernel_sizes, dropout,
                                               compute_dtype)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor,
                dropout: Optional[torch.Generator] = None) -> torch.Tensor:
        """pad_mask: [B, T] True at padding (keys masked, queries zeroed)."""
        pad = pad_mask[..., None]
        out = self.slf_attn(x, pad_mask, dropout).masked_fill(pad, 0.0)
        return self.pos_ffn(out, dropout).masked_fill(pad, 0.0)


class TextEncoder(nn.Module):
    """Phoneme embedding + sinusoid positions + FFT blocks
    (reference transformer/Models.py:33-84)."""

    def __init__(self, vocab_size, max_seq_len, d_model=256, n_layers=2,
                 n_head=4, d_inner=1024, kernel_sizes=(9, 1), dropout=0.2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.src_word_emb = nn.Parameter(torch.zeros(vocab_size, d_model))
        self.positions = _PositionTable(d_model)
        for i in range(n_layers):
            self.add_module(
                f"layer_{i}",
                FFTBlock(d_model, d_inner, n_head, kernel_sizes, dropout, compute_dtype),
            )
        self.n_layers = n_layers

    def forward(self, src_seq: torch.Tensor, src_mask: torch.Tensor,
                dropout: Optional[torch.Generator] = None) -> torch.Tensor:
        # padding_idx=0: row 0 of the table reads as zero
        x = F.embedding(src_seq, self.src_word_emb)
        x = x.masked_fill((src_seq == 0)[..., None], 0.0)
        L = x.shape[1]
        pos = self.positions.table(max(self.max_seq_len + 1, L), x.device)
        x = x + pos[None, :L]
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, src_mask, dropout)
        return x


class MelDecoder(nn.Module):
    """FFT-block decoder over frame-domain encodings
    (reference transformer/Models.py:87-135)."""

    def __init__(self, max_seq_len, d_model=256, n_layers=4, n_head=4,
                 d_inner=1024, kernel_sizes=(9, 1), dropout=0.2,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.max_seq_len = max_seq_len
        self.positions = _PositionTable(d_model)
        for i in range(n_layers):
            self.add_module(
                f"layer_{i}",
                FFTBlock(d_model, d_inner, n_head, kernel_sizes, dropout, compute_dtype),
            )
        self.n_layers = n_layers

    def forward(self, x: torch.Tensor, mel_mask: torch.Tensor,
                dropout: Optional[torch.Generator] = None) -> torch.Tensor:
        T = x.shape[1]
        # the table has max_seq_len+1 rows; a longer frame axis gets its
        # own table (reference Models.py:120-122)
        pos = self.positions.table(max(self.max_seq_len + 1, T), x.device)
        x = x + pos[None, :T]
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, mel_mask, dropout)
        return x


class FlaxBatchNorm1d(nn.BatchNorm1d):
    """BatchNorm over [B, C, T] with flax's running-statistics update.

    In train mode flax's ``nn.BatchNorm(momentum=0.9)`` normalises with the
    batch statistics over all B*T positions (padding included) and moves
    the running variance towards the BIASED batch variance;
    ``nn.BatchNorm1d`` would move it towards the unbiased one, a factor
    n/(n-1) apart. ``momentum`` here is torch's (0.1 = flax's 0.9).
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2), unbiased=False)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)


class PostNet(nn.Module):
    """Tacotron2 PostNet (reference transformer/Layers.py:67-130):
    5x [Conv1d k5 -> BatchNorm -> tanh (except last) -> dropout 0.5]."""

    def __init__(self, n_mel_channels=80, embedding_dim=512, kernel_size=5, n_convolutions=5,
                 dropout: float = 0.5, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_convolutions = n_convolutions
        self.dropout = dropout
        for i in range(n_convolutions):
            c_in = n_mel_channels if i == 0 else embedding_dim
            c_out = n_mel_channels if i == n_convolutions - 1 else embedding_dim
            self.add_module(
                f"conv_{i}",
                Conv1d(c_in, c_out, kernel_size, (kernel_size - 1) // 2, compute_dtype),
            )
            self.add_module(f"bn_{i}", FlaxBatchNorm1d(c_out, eps=1e-5, momentum=0.1))

    def forward(self, mel: torch.Tensor, dropout: Optional[torch.Generator] = None) -> torch.Tensor:
        x = mel.transpose(1, 2)
        for i in range(self.n_convolutions):
            x = getattr(self, f"bn_{i}")(getattr(self, f"conv_{i}")(x).float())
            if i < self.n_convolutions - 1:
                x = torch.tanh(x)
            x = _dropout(x, self.dropout, dropout)
        return x.transpose(1, 2)
