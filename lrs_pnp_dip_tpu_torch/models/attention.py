"""Attention building blocks (counterpart of
``lrs_pnp_dip_tpu/models/attention.py``; reference
``models/SubLayers.py:11-135``): scaled dot-product attention, multi-head
attention (projections, per-head attention, output projection, residual and
LayerNorm), the position-wise feed-forward block and the sinusoidal position
table.

The attention is the einsum / softmax form of the JAX package, which computes
it in plain XLA; ``F.scaled_dot_product_attention`` would sum in another
order.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from .common import Dense, LayerNorm, ZooModule


def scaled_dot_product_attention(q, k, v, temperature=None, mask=None):
    """q, k, v: (..., L, D).  Returns (out, attn)."""
    if temperature is None:
        temperature = math.sqrt(q.shape[-1])
    scores = torch.einsum("...ld,...md->...lm", q, k) / temperature
    if mask is not None:
        scores = torch.where(mask, scores, -1e9)
    attn = torch.softmax(scores, dim=-1)
    return torch.einsum("...lm,...md->...ld", attn, v), attn


def _dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scale by 1 / (1 - rate)."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class MultiHeadAttention(ZooModule):
    def __init__(self, n_head: int = 8, d_model: int = 512, d_k: int = 64, d_v: int = 64,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.dropout_rate = dropout_rate
        # projections of q, k and v, the output projection, the norm
        self.layers = tuple(
            self.add(m) for m in (Dense(d_model, n_head * d_k), Dense(d_model, n_head * d_k),
                                  Dense(d_model, n_head * d_v), Dense(n_head * d_v, d_model),
                                  LayerNorm(d_model))
        )

    def forward(self, q, k, v, mask=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """(B, L, d_model) queries, keys and values; ``mask`` (B, Lq, Lk).
        Returns (out, attn)."""
        w_q, w_k, w_v, w_o, norm = self.layers
        residual = q
        B, Lq, _ = q.shape
        Lk = k.shape[1]

        def heads(x, proj, d, L):
            return proj(x).reshape(B, L, self.n_head, d).transpose(1, 2)

        qh = heads(q, w_q, self.d_k, Lq)
        kh = heads(k, w_k, self.d_k, Lk)
        vh = heads(v, w_v, self.d_v, Lk)
        if mask is not None:
            mask = mask[:, None]  # broadcast over heads
        out, attn = scaled_dot_product_attention(qh, kh, vh, mask=mask)
        out = w_o(out.transpose(1, 2).reshape(B, Lq, self.n_head * self.d_v))
        if self.dropout_rate > 0 and not deterministic:
            out = _dropout(out, self.dropout_rate, generator)
        return norm(out + residual), attn


class PositionwiseFeedForward(ZooModule):
    def __init__(self, d_in: int, d_hid: int, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.layers = (self.add(Dense(d_in, d_hid)), self.add(Dense(d_hid, d_in)), self.add(LayerNorm(d_in)))

    def forward(self, x, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        w_1, w_2, norm = self.layers
        y = w_2(F.relu(w_1(x)))
        if self.dropout_rate > 0 and not deterministic:
            y = _dropout(y, self.dropout_rate, generator)
        return norm(y + x)


def sinusoid_position_encoding(n_position: int, d_hid: int) -> torch.Tensor:
    """(1, n_position, d_hid) sinusoidal table."""
    pos = np.arange(n_position)[:, None]
    dim = np.arange(d_hid)[None, :]
    angle = pos / np.power(10000, 2 * (dim // 2) / d_hid)
    table = np.zeros((n_position, d_hid))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return torch.tensor(table[None], dtype=torch.float32)
