"""Layout-aware field-extraction transformer (port of
ocr_system_tpu/models/layout_extractor.py).

A LayoutLM-style encoder: character tokens (the multilingual charset) plus
each token's word box, quantized to 0..1023 per axis, in; per-token BIO
tags over {key, value}, per-token field types and a calibrated token
confidence, and a pooled form-type class, out.

Arithmetic follows the flax module at ``dtype=compute, param_dtype=float32``
(the serving policy): every Dense kernel and bias, both embedding tables and
the position table are cast to the compute dtype at use, LayerNorm keeps
float32 statistics and parameters (``models/layers``), attention logits
take a -1e9 mask bias in their own dtype, the MLP uses the tanh GELU
(flax ``nn.gelu``), and the heads' outputs are cast to float32. The
embeddings add left to right, ``((tok + c0) + c1) + c2 + c3 + pos``, which
matters in bf16. Attention is plain PyTorch (the JAX package computes it
in plain XLA, outside any Pallas kernel). Sequence-parallel ring attention
is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ocr_system_tpu_torch.models.layers import Dense, LayerNorm, init_random_
from ocr_system_tpu_torch.service.validation import FieldType

# BIO tag space: O + {B-,I-} x {key, value}. Field type is predicted
# separately per token so tag and type heads stay small and balanced.
TAGS = ("O", "B-KEY", "I-KEY", "B-VAL", "I-VAL")
NUM_TAGS = len(TAGS)
FIELD_TYPES = tuple(ft.value for ft in FieldType)
NUM_FIELD_TYPES = len(FIELD_TYPES)
FORM_TYPES = (
    "Unknown", "Invoice", "Receipt", "Application Form", "Medical Form",
    "Survey", "Purchase Order", "Tax Form", "Contract",
)
NUM_FORM_TYPES = len(FORM_TYPES)
COORD_BUCKETS = 1024  # quantized page coords 0..1023
MASK_BIAS = -1e9


class Block(nn.Module):
    """Pre-norm transformer block: fused-QKV attention, then a GELU MLP."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.heads = heads
        self.norm1 = LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.up = Dense(dim, dim * mlp_ratio)
        self.down = Dense(dim * mlp_ratio, dim)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.heads
        hd = d // h
        # the fused product splits into q, k, v, each head-major: (b, h, t, hd)
        q, k, v = (
            z.reshape(b, t, h, hd).transpose(1, 2)
            for z in self.qkv(self.norm1(x)).split(d, dim=-1)
        )
        logits = torch.matmul(q, k.transpose(-1, -2)) * hd**-0.5
        attn = torch.softmax(logits + bias, dim=-1)
        y = torch.matmul(attn, v).transpose(1, 2).reshape(b, t, d)
        x = x + self.proj(y)
        y = self.up(self.norm2(x))
        y = self.down(F.gelu(y, approximate="tanh"))
        return x + y


class LayoutExtractor(nn.Module):
    def __init__(
        self,
        vocab_size: int,
        dim: int = 256,
        depth: int = 6,
        heads: int = 8,
        max_len: int = 2048,
        sequence_parallel: bool = False,
    ):
        super().__init__()
        if sequence_parallel:
            raise ValueError(
                "sequence-parallel (ring) attention is not ported; the port "
                "serves long documents through the page-chunk path"
            )
        self.max_len = max_len
        self.tok_embed = nn.Embedding(vocab_size, dim)
        self.coord_embed = nn.Embedding(COORD_BUCKETS, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, max_len, dim))
        self.blocks = nn.ModuleList(Block(dim, heads) for _ in range(depth))
        self.norm = LayerNorm(dim)
        self.tag_head = Dense(dim, NUM_TAGS)
        self.type_head = Dense(dim, NUM_FIELD_TYPES)
        self.conf_head = Dense(dim, 1)
        self.form_head = Dense(dim, NUM_FORM_TYPES)

    def init_random_(self, generator: torch.Generator) -> "LayoutExtractor":
        """Seeded random weights: LeCun-normal Dense kernels, zero biases,
        unit LayerNorm, N(0, 0.02) embeddings (flax's defaults there)."""
        init_random_(self, generator)
        with torch.no_grad():
            for p in (self.tok_embed.weight, self.coord_embed.weight, self.pos_embed):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        return self

    def forward(
        self,
        token_ids: torch.Tensor,
        boxes: torch.Tensor,
        mask: torch.Tensor,
        dtype: torch.dtype = torch.float32,
    ) -> dict[str, torch.Tensor]:
        """token_ids: (B, L) int; boxes: (B, L, 4) int in [0, 1024)
        (x0, y0, x1, y1 quantized); mask: (B, L), nonzero = valid; dtype:
        the compute dtype.

        Returns tag_logits (B, L, NUM_TAGS), type_logits (B, L,
        NUM_FIELD_TYPES), form_logits (B, NUM_FORM_TYPES) and confidence
        (B, L) in [0, 1], all float32."""
        mask = mask.bool()

        def coord(i: int) -> torch.Tensor:
            return self.coord_embed(boxes[..., i]).to(dtype)

        x = self.tok_embed(token_ids).to(dtype)
        x = x + coord(0) + coord(1)
        x = x + coord(2) + coord(3)
        x = x + self.pos_embed[:, : x.shape[1]].to(dtype)
        bias = torch.zeros(mask.shape, dtype=dtype, device=x.device).masked_fill(
            ~mask, MASK_BIAS)[:, None, None, :]
        for blk in self.blocks:
            x = blk(x, bias)
        x = self.norm(x)

        conf = torch.sigmoid(self.conf_head(x))[..., 0]
        m = mask[..., None].to(dtype)
        denom = mask.sum(dim=1, keepdim=True).clamp_min(1).to(dtype)
        form_logits = self.form_head((x * m).sum(dim=1) / denom)
        return {
            "tag_logits": self.tag_head(x).float(),
            "type_logits": self.type_head(x).float(),
            "form_logits": form_logits.float(),
            "confidence": conf.float(),
        }
