"""Greedy CTC decoding for the recognition head (port of
ocr_system_tpu/ops/ctc.py): argmax + shift-dedup + left-packing on the
device; only the id matrix crosses to the host for the charset lookup."""

from __future__ import annotations

import numpy as np
import torch

BLANK_ID = 0  # convention: charset index 0 is the CTC blank
PAD_ID = -1  # padding value in decoded id matrices


def ctc_greedy_decode(
    logits: torch.Tensor,
    lengths: torch.Tensor | None = None,
    blank_id: int = BLANK_ID,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best-path CTC decode. logits (B, T, V); lengths (B,) valid steps.

    Returns ids (B, T) int32 left-packed with PAD_ID after the decoded
    symbols, conf (B,) float32 mean max-prob over the kept steps (0 when
    nothing decodes), and n (B,) int32 decoded-symbol counts."""
    b, t, _ = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    best_p, best = probs.max(dim=-1)
    best = best.to(torch.int32)
    steps = torch.arange(t, device=logits.device)[None, :]
    valid = steps < (lengths[:, None] if lengths is not None else t)
    prev = torch.cat([torch.full_like(best[:, :1], -1), best[:, :-1]], dim=1)
    keep = (best != blank_id) & (best != prev) & valid
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    pos = torch.where(keep, pos, torch.full_like(pos, t))  # overflow column
    out = torch.full((b, t + 1), PAD_ID, dtype=torch.int32, device=logits.device)
    out.scatter_(1, pos, best)
    ids = out[:, :t]
    n = keep.sum(dim=1).to(torch.int32)
    kept_p_sum = torch.where(keep, best_p, torch.zeros_like(best_p)).sum(dim=1)
    conf = torch.where(
        n > 0, kept_p_sum / n.clamp(min=1), torch.zeros_like(kept_p_sum)
    )
    return ids, conf, n


_LOOKUP_CACHE: dict[str, np.ndarray] = {}


def _char_table(charset) -> np.ndarray:
    tbl = _LOOKUP_CACHE.get(charset.name)
    if tbl is None:
        tbl = np.array(["\0"] + list(charset.chars), dtype="U1")
        _LOOKUP_CACHE[charset.name] = tbl
    return tbl


def ids_to_text(ids, charset) -> list[str]:
    """Host-side: (B, T) padded id matrix -> list of strings via ``charset``;
    each row stops at its first PAD_ID."""
    ids = np.asarray(ids)
    if ids.ndim == 1:
        ids = ids[None]
    valid = ids != PAD_ID
    prefix = np.cumprod(valid, axis=1, dtype=bool)
    emit = prefix & (ids > 0) & (ids <= len(charset.chars))
    n = emit.sum(axis=1)
    chars = _char_table(charset)[np.where(emit, ids, 0)]
    joined = "".join(chars[emit].tolist())
    bounds = np.concatenate([[0], np.cumsum(n)]).tolist()
    return [joined[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
