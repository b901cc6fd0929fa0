"""SVTR-style text-line recognizer with a CTC head (port of
ocr_system_tpu/models/recognizer.py): a conv stem that collapses height,
transformer mixer blocks over the width axis, then a CTC projection.

Input crops are (B, 48, W, 3) as in the JAX model (``forward``) or
(B, 3, 48, W) (``forward_nchw``); the time axis is W/4 after the stem.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ocr_system_tpu_torch.core.dtypes import DTypePolicy, default_policy
from ocr_system_tpu_torch.models.backbone import ConvBNAct
from ocr_system_tpu_torch.models.layers import Dense, LayerNorm


class MixerBlock(nn.Module):
    """Pre-norm transformer block: masked multi-head self-attention written
    out as matmul + masked softmax (flax ``MultiHeadDotProductAttention``,
    keys masked only), then a tanh-GELU MLP."""

    def __init__(self, dim: int, heads: int = 4, mlp_ratio: int = 4):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(dim)
        self.query = Dense(dim, dim)
        self.key = Dense(dim, dim)
        self.value = Dense(dim, dim)
        self.out = Dense(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.fc1 = Dense(dim, dim * mlp_ratio)
        self.fc2 = Dense(dim * mlp_ratio, dim)

    def attention(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, t, d = h.shape
        hd = d // self.heads

        def split(x):  # (B, T, D) -> (B, H, T, hd)
            return x.view(b, t, self.heads, hd).transpose(1, 2)

        q = split(self.query(h)) / torch.tensor(hd**0.5, dtype=h.dtype)
        k, v = split(self.key(h)), split(self.value(h))
        logits = q @ k.transpose(-1, -2)  # (B, H, T, T)
        logits = logits.masked_fill(
            ~mask[:, None, None, :], torch.finfo(logits.dtype).min
        )
        w = torch.softmax(logits.float(), dim=-1).to(h.dtype)
        return self.out((w @ v).transpose(1, 2).reshape(b, t, d))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.attention(self.norm1(x), mask)
        h = self.fc2(F.gelu(self.fc1(self.norm2(x)), approximate="tanh"))
        return x + h


class SVTRRecognizer(nn.Module):
    def __init__(self, vocab_size: int, dim: int = 192, depth: int = 6,
                 heads: int = 6, policy: DTypePolicy = default_policy()):
        super().__init__()
        self.policy = policy
        self.stem = nn.Sequential(
            ConvBNAct(3, dim // 4, 3, stride=(2, 2)),
            ConvBNAct(dim // 4, dim // 2, 3, stride=(2, 2)),
            ConvBNAct(dim // 2, dim, 3, stride=(2, 1)),
        )
        self.pos_embed = nn.Parameter(torch.zeros(1, 512, dim))
        self.blocks = nn.ModuleList(
            MixerBlock(dim, heads) for _ in range(depth)
        )
        self.norm = LayerNorm(dim)
        self.head = nn.Linear(dim, vocab_size)

    def forward(self, x_nhwc: torch.Tensor, widths: torch.Tensor | None = None):
        return self.forward_nchw(x_nhwc.permute(0, 3, 1, 2), widths)

    def forward_nchw(self, x: torch.Tensor, widths: torch.Tensor | None = None):
        """x: (B, 3, 48, W); widths: (B,) valid pixel widths (<= W).
        Returns (logits (B, T, V) float32, logit_lengths (B,) int32),
        T = W // 4."""
        w_in = x.shape[-1]
        x = self.stem(self.policy.cast_compute(x))
        x = x.mean(dim=2).transpose(1, 2)  # collapse height: (B, T, D)
        b, t, _ = x.shape
        if widths is None:
            lengths = torch.full((b,), t, dtype=torch.int32, device=x.device)
        else:
            lengths = torch.ceil(widths.float() / (w_in / t)).to(torch.int32)
            lengths = lengths.clamp(1, t)
        steps = torch.arange(t, device=x.device)
        mask = steps[None, :] < lengths[:, None]
        x = x + self.pos_embed[:, :t].to(x.dtype)
        for block in self.blocks:
            x = block(x, mask)
        x = self.norm(x)
        # the CTC projection runs in float32 (flax Dense(dtype=float32))
        logits = F.linear(x.float(), self.head.weight, self.head.bias)
        return logits, lengths
