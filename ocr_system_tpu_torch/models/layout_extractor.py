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
in plain XLA, outside any Pallas kernel); with ``sequence_parallel`` a block
serves exact ring attention over the current mesh's ``sp`` axis
(``parallel/ring_attention``). Every weight carries the JAX module's
logical axes (``Dense.axes``, ``PARAM_AXES``), so ``parallel.sharding.
shard_params`` can split the mlp and heads dimensions over ``tp``; a block
with sharded weights computes the same function on its tp devices.
Training slides each sample's window of the position table (``pos_offset``)
and minimises ``extraction_loss``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ocr_system_tpu_torch.core.dtypes import widen
from ocr_system_tpu_torch.core.mesh import TENSOR_AXIS, get_mesh
from ocr_system_tpu_torch.models.layers import Dense, LayerNorm, init_flax_, init_random_
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


class _Embedding(nn.Embedding):
    PARAM_AXES = {"weight": ("vocab", "embed")}


def _attention(q, k, v, bias: torch.Tensor) -> torch.Tensor:
    """Softmax attention with an additive mask bias: q, k, v (b, t, h, hd)
    -> (b, t, h, hd), computed head-major."""
    q, k, v = (z.transpose(1, 2) for z in (q, k, v))
    logits = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    attn = torch.softmax(logits + bias, dim=-1)
    return torch.matmul(attn, v).transpose(1, 2)


class Block(nn.Module):
    """Pre-norm transformer block: fused-QKV attention, then a GELU MLP.
    ``sequence_parallel``: ring attention over the current mesh's ``sp``
    axis (the sequence length must divide over it)."""

    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 sequence_parallel: bool = False):
        super().__init__()
        self.heads = heads
        self.sequence_parallel = sequence_parallel
        self.norm1 = LayerNorm(dim)
        # the fused kernel's q, k and v each split over tp by whole heads
        self.qkv = Dense(dim, 3 * dim, axes=("embed", "heads"), shard_groups=3,
                         shard_unit=dim // heads)
        self.proj = Dense(dim, dim, axes=("heads", "embed"))
        self.norm2 = LayerNorm(dim)
        self.up = Dense(dim, dim * mlp_ratio, axes=("embed", "mlp"))
        self.down = Dense(dim * mlp_ratio, dim, axes=("mlp", "embed"))

    def forward(self, x: torch.Tensor, bias: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (b, t, d); bias: the (b, 1, 1, t) additive mask of the dense
        path; mask: (b, t) bool, ring attention's."""
        from ocr_system_tpu_torch.parallel.sharding import ShardedDense

        if isinstance(self.qkv, ShardedDense):
            return self._forward_tp(x, bias)
        b, t, d = x.shape
        h = self.heads
        q, k, v = (z.reshape(b, t, h, d // h) for z in self.qkv(self.norm1(x)).split(d, dim=-1))
        if self.sequence_parallel:
            from ocr_system_tpu_torch.parallel.ring_attention import ring_attention

            y = ring_attention(q, k, v, mask, get_mesh())
        else:
            y = _attention(q, k, v, bias)
        x = x + self.proj(y.reshape(b, t, d))
        y = self.up(self.norm2(x))
        y = self.down(F.gelu(y, approximate="tanh"))
        return x + y

    def _forward_tp(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        """The block with its weights split over tp: each tp device computes
        its heads' attention and its slice of the MLP; the row-parallel
        ``proj`` and ``down`` sum over tp. Activations live on x's device,
        the first of the shard's tp devices."""
        if self.sequence_parallel:
            raise ValueError("a tp-sharded block serves no ring attention")
        b, t, d = x.shape
        devs = self.qkv.mesh.axis_devices(TENSOR_AXIS)
        h, dl = self.heads // len(devs), d // len(devs)
        y1 = self.norm1(x)
        parts = []
        for j, dev in enumerate(devs):
            qkv = self.qkv.shard_forward(j, y1.to(dev))
            q, k, v = (z.reshape(b, t, h, dl // h) for z in qkv.split(dl, dim=-1))
            y = _attention(q, k, v, bias.to(dev)).reshape(b, t, dl)
            parts.append(self.proj.shard_forward(j, y))
        x = x + self.proj.reduce(parts, x.device)
        y2 = self.norm2(x)
        parts = [self.down.shard_forward(j, F.gelu(self.up.shard_forward(j, y2.to(dev)),
                                                   approximate="tanh"))
                 for j, dev in enumerate(devs)]
        return x + self.down.reduce(parts, x.device)


class LayoutExtractor(nn.Module):
    # the logical axes of the parameters that are not a Dense's
    PARAM_AXES = {"pos_embed": (None, None, "embed")}

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
        self.max_len = max_len
        self.sequence_parallel = sequence_parallel
        self.tok_embed = _Embedding(vocab_size, dim)
        self.coord_embed = _Embedding(COORD_BUCKETS, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, max_len, dim))
        self.blocks = nn.ModuleList(
            Block(dim, heads, sequence_parallel=sequence_parallel) for _ in range(depth))
        self.norm = LayerNorm(dim)
        self.tag_head = Dense(dim, NUM_TAGS, axes=("embed", "tags"))
        self.type_head = Dense(dim, NUM_FIELD_TYPES, axes=("embed", "types"))
        self.conf_head = Dense(dim, 1, axes=("embed", "one"))
        self.form_head = Dense(dim, NUM_FORM_TYPES, axes=("embed", "forms"))

    def init_random_(self, generator: torch.Generator) -> "LayoutExtractor":
        """Seeded random weights: LeCun-normal Dense kernels, zero biases,
        unit LayerNorm, N(0, 0.02) embeddings (flax's defaults there)."""
        init_random_(self, generator)
        with torch.no_grad():
            for p in (self.tok_embed.weight, self.coord_embed.weight, self.pos_embed):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        return self

    def init_flax_(self, generator: torch.Generator) -> "LayoutExtractor":
        """flax's initializers for this module: ``xavier_uniform`` Dense
        kernels, zero biases, unit LayerNorm, ``normal(0.02)`` embeddings
        and position table."""
        init_flax_(self, generator)
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Linear):
                    fan_out, fan_in = m.weight.shape
                    limit = (6.0 / (fan_in + fan_out)) ** 0.5
                    m.weight.copy_(
                        (torch.rand(m.weight.shape, generator=generator) * 2 - 1) * limit)
            for p in (self.tok_embed.weight, self.coord_embed.weight, self.pos_embed):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)
        return self

    def forward(
        self,
        token_ids: torch.Tensor,
        boxes: torch.Tensor,
        mask: torch.Tensor,
        dtype: torch.dtype = torch.float32,
        pos_offset: torch.Tensor | None = None,
    ) -> dict[str, torch.Tensor]:
        """token_ids: (B, L) int; boxes: (B, L, 4) int in [0, 1024)
        (x0, y0, x1, y1 quantized); mask: (B, L), nonzero = valid; dtype:
        the compute dtype; pos_offset: optional (B,) int, each sample's start
        in the position table (training slides windows over all ``max_len``
        positions; serving starts at 0). A start past ``max_len - L`` is
        clamped, as ``jax.lax.dynamic_slice`` does.

        Returns tag_logits (B, L, NUM_TAGS), type_logits (B, L,
        NUM_FIELD_TYPES), form_logits (B, NUM_FORM_TYPES) and confidence
        (B, L) in [0, 1], all float32."""
        mask = mask.bool()

        def coord(i: int) -> torch.Tensor:
            return self.coord_embed(boxes[..., i]).to(dtype)

        x = self.tok_embed(token_ids).to(dtype)
        x = x + coord(0) + coord(1)
        x = x + coord(2) + coord(3)
        t = x.shape[1]
        if pos_offset is None:
            pos = self.pos_embed[:, :t]
        else:
            start = pos_offset.long().clamp(0, self.max_len - t)
            pos = self.pos_embed[0][start[:, None] + torch.arange(t, device=x.device)]
        x = x + pos.to(dtype)
        bias = torch.zeros(mask.shape, dtype=dtype, device=x.device).masked_fill(
            ~mask, MASK_BIAS)[:, None, None, :]
        for blk in self.blocks:
            x = blk(x, bias, mask)
        x = self.norm(x)

        conf = torch.sigmoid(self.conf_head(x))[..., 0]
        m = mask[..., None].to(dtype)
        denom = mask.sum(dim=1, keepdim=True).clamp_min(1).to(dtype)
        form_logits = self.form_head((x * m).sum(dim=1) / denom)
        return {
            "tag_logits": widen(self.tag_head(x)),
            "type_logits": widen(self.type_head(x)),
            "form_logits": widen(form_logits),
            "confidence": widen(conf),
        }


def extraction_loss(outputs: dict, tags: torch.Tensor, types: torch.Tensor,
                    form: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Token-tag CE + token-type CE (on non-O tokens) + 0.2 x form CE.
    tags/types: (B, L) int labels; form: (B,) int; mask: (B, L)."""
    return extraction_loss_finish(extraction_loss_terms(outputs, tags, types, form, mask),
                                  form.shape[0])


def extraction_loss_terms(outputs: dict, tags: torch.Tensor, types: torch.Tensor,
                          form: torch.Tensor, mask: torch.Tensor) -> dict:
    """The sums ``extraction_loss`` divides: each cross-entropy is a masked
    mean over the whole batch, so a dp batch sums these over its shards
    before ``extraction_loss_finish`` (a mean of the shards' means would
    weigh a shard by its sample count, not its tokens)."""
    mask = mask.float()
    typed = mask * (tags > 0)

    def nll(logits, labels):
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, labels.long()[..., None])[..., 0]

    return {
        "tag": (nll(outputs["tag_logits"], tags) * mask).sum(), "tag_n": mask.sum(),
        "type": (nll(outputs["type_logits"], types) * typed).sum(), "type_n": typed.sum(),
        "form": nll(outputs["form_logits"], form).sum(),
    }


def extraction_loss_finish(t: dict, batch: int) -> torch.Tensor:
    """``extraction_loss`` from its (summed) terms and the global batch."""
    tag_loss = t["tag"] / t["tag_n"].clamp_min(1.0)
    type_loss = t["type"] / t["type_n"].clamp_min(1.0)
    return tag_loss + type_loss + 0.2 * (t["form"] / batch)
