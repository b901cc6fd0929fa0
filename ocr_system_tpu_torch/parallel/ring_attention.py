"""Ring attention: sequence-parallel exact attention over the mesh, and the
long-document merge (port of ocr_system_tpu/parallel/ring_attention.py).

``ring_attention`` is blockwise ring attention (Liu et al.'s formulation):
the sequence splits over the mesh's ``sp`` axis, each device keeps its
query block, and the K/V blocks travel the ring (``core.mesh.ppermute``)
while each query block accumulates an online softmax, so the full attention
matrix never forms. The arithmetic is the JAX package's ``_online_block``:
the same constants (a -1e30 mask, a running max starting at -inf, a final
divide by max(row_sum, 1e-30)), the same dtypes (the query's) and the same
block order (a device's own block first, then the block of the device
before it on the ring, and so on). It is exact attention, not the dense
path's -1e9 bias: the two differ by far less than the logits' rounding in
bf16 (the JAX tests allow 5e-2 between them).

``chunked_extract_merge`` is the host half: per-chunk extraction results
of a document longer than one window, map-reduced into one.
"""

from __future__ import annotations

import torch

from ocr_system_tpu_torch.core.mesh import Mesh, all_gather, ppermute
from ocr_system_tpu_torch.extract.types import ExtractionResult

SEQ_AXIS = "sp"
MASK_VALUE = -1e30


def _online_block(carry, kv, q, scale, mask_value=MASK_VALUE):
    """One online-softmax accumulation step.

    carry: (acc (B,Tq,H,D), row_max (B,H,Tq), row_sum (B,H,Tq))
    kv:    (k_blk (B,Tk,H,D), v_blk (B,Tk,H,D), valid (B,Tk) bool)
    """
    acc, row_max, row_sum = carry
    k_blk, v_blk, valid = kv
    logits = torch.matmul(q.transpose(1, 2), k_blk.permute(0, 2, 3, 1)) * scale  # (B,H,Tq,Tk)
    logits = logits.masked_fill(~valid[:, None, None, :], mask_value)
    blk_max = logits.amax(dim=-1)  # (B,H,Tq)
    new_max = torch.maximum(row_max, blk_max)
    correction = torch.exp(row_max - new_max)
    p = torch.exp(logits - new_max[..., None])
    blk_sum = p.sum(dim=-1)
    new_sum = row_sum * correction + blk_sum
    pv = torch.matmul(p, v_blk.transpose(1, 2)).transpose(1, 2)  # (B,Tq,H,D)
    new_acc = acc * correction.transpose(1, 2)[..., None] + pv
    return new_acc, new_max, new_sum


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                   mesh: Mesh, axis: str = SEQ_AXIS) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``axis``.

    q, k, v: (B, T, H, D) with T divisible by mesh.shape[axis]; mask: (B,
    T), nonzero = valid. Returns (B, T, H, D) on q's device.

    Device i holds the i-th T/n of the sequence; after each of the n
    accumulation steps the K/V/mask blocks move one device on along the
    ring, so at step s device i holds the block of device (i - s) mod n.
    """
    devs = mesh.axis_devices(axis)
    n = len(devs)
    if q.shape[1] % n:
        raise ValueError(f"sequence {q.shape[1]} does not split over {axis}={n}")
    scale = q.shape[-1] ** -0.5

    def split(x):
        return [c.to(d) for c, d in zip(x.chunk(n, dim=1), devs)]

    qs, ks, vs, ms = split(q), split(k), split(v), split(mask.bool())
    carries = []
    for q_blk in qs:
        b, tq, h, _ = q_blk.shape
        carries.append((torch.zeros_like(q_blk),
                        torch.full((b, h, tq), -torch.inf, dtype=q_blk.dtype,
                                   device=q_blk.device),
                        torch.zeros((b, h, tq), dtype=q_blk.dtype, device=q_blk.device)))
    for step in range(n):
        carries = [_online_block(c, (kb, vb, mb), qb, scale)
                   for c, qb, kb, vb, mb in zip(carries, qs, ks, vs, ms)]
        if step < n - 1:  # (the JAX loop's last rotation is never read)
            ks, vs, ms = (ppermute(x, mesh, axis) for x in (ks, vs, ms))
    outs = []
    for acc, _, row_sum in carries:
        denom = row_sum.clamp_min(1e-30).transpose(1, 2)[..., None]
        outs.append(acc / denom)
    return all_gather(outs, dim=1, device=q.device)


def dense_attention_reference(q, k, v, mask):
    """Dense reference for tests: softmax attention with the -1e30 mask."""
    scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.transpose(1, 2), k.permute(0, 2, 3, 1)) * scale
    logits = logits.masked_fill(~mask.bool()[:, None, None, :], MASK_VALUE)
    p = torch.softmax(logits, dim=-1)
    return torch.matmul(p, v.transpose(1, 2)).transpose(1, 2)

def chunked_extract_merge(chunk_results: list[ExtractionResult]) -> ExtractionResult:
    """The pragmatic first tier for long documents (SURVEY §5.7): per-chunk
    extraction results map-reduced into one ExtractionResult. Earlier chunks
    win key conflicts (reading order); confidences carry through."""
    merged = ExtractionResult()
    seen: set[tuple[str, str]] = set()
    for r in chunk_results:
        if not r.success:
            continue
        for f in r.fields:
            key = f.field_key.strip().lower()
            # keyed fields dedup by key (earlier chunk wins); orphan values
            # (empty key) dedup by value — chunk OVERLAP re-decodes the tail
            # of each chunk, which would otherwise duplicate them
            sig = (key, "" if key else f.field_value.strip().lower())
            if sig in seen:
                continue
            seen.add(sig)
            merged.fields.append(f)
        merged.token_count += r.token_count
        merged.processing_time_ms += r.processing_time_ms
        if merged.form_type == "Unknown" and r.form_type != "Unknown":
            merged.form_type = r.form_type
        if merged.language == "en" and r.language != "en":
            merged.language = r.language
    merged.success = bool(chunk_results) and any(r.success for r in chunk_results)
    return merged
