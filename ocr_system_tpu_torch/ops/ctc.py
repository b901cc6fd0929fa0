"""CTC for the recognition head (port of ocr_system_tpu/ops/ctc.py): greedy
decoding (argmax + shift-dedup + left-packing on the device; only the id
matrix crosses to the host for the charset lookup) and, for training, the
CTC loss with optax's values."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ocr_system_tpu_torch.core.dtypes import widen

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


LOG_EPSILON = -1e5  # optax's stand-in for log(0)


class _LogAddExp(torch.autograd.Function):
    """``log(exp(a) + exp(b))`` with JAX's arithmetic: ``max + log1p(exp(-|a
    - b|))`` forward and ``g * exp(a - out)`` backward (``torch.logaddexp``
    differentiates through ``sigmoid(a - b)`` instead). At the -1e5 floor a
    float32 ulp is 0.008, so the two formulas give an infeasible line
    gradients a few percent apart; this one gives optax's. The recursion's
    values are finite, so JAX's handling of infinities is not needed."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b) + torch.log1p(torch.exp(-(a - b).abs()))
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


_logaddexp = _LogAddExp.apply


def ctc_loss(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = BLANK_ID,
    log_epsilon: float = LOG_EPSILON,
) -> torch.Tensor:
    """Mean over the batch of each line's CTC loss, -log p(labels | logits)
    (``ctc_line_losses``): the mean is over lines, not divided by the label
    lengths as ``F.ctc_loss(reduction="mean")`` is."""
    return ctc_line_losses(logits, logit_lengths, labels, label_lengths, blank_id,
                           log_epsilon).mean()


def ctc_line_losses(
    logits: torch.Tensor,
    logit_lengths: torch.Tensor,
    labels: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = BLANK_ID,
    log_epsilon: float = LOG_EPSILON,
) -> torch.Tensor:
    """Each line's CTC loss, -log p(labels | logits), as a (B,) tensor.

    logits (B, T, V); logit_lengths (B,) valid steps; labels (B, N) padded
    on the right; label_lengths (B,). The forward recursion of
    ``optax.ctc_loss`` written out step by step in PyTorch, so values and
    gradients are optax's: log(0) is floored at ``log_epsilon``, which keeps
    an infeasible line (more labels and repeats than steps) finite where
    ``F.ctc_loss`` gives inf."""
    b, t, _ = logits.shape
    n = labels.shape[1]
    logprobs = torch.log_softmax(widen(logits), dim=-1)
    labels = labels.long()
    # repeat[b, i] == 1 where label i equals label i + 1
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    phi_lp = logprobs[:, :, blank_id].T[..., None]  # (T, B, 1)
    emit_lp = logprobs.gather(2, labels[:, None, :].expand(b, t, n)).transpose(0, 1)
    pad = (torch.arange(t, device=logits.device)[:, None]
           >= logit_lengths.to(logits.device)[None, :]).float()[..., None]  # (T, B, 1)

    def add_to_phi(phi, score):  # phi[:, 1:] += score in log space
        return torch.cat([phi[:, :1], _logaddexp(phi[:, 1:], score)], dim=-1)

    phi = torch.full((b, n + 1), log_epsilon, device=logits.device)
    phi = torch.cat([torch.zeros_like(phi[:, :1]), phi[:, 1:]], dim=-1)
    emit = torch.full((b, n), log_epsilon, device=logits.device)
    for s in range(t):
        prev_phi_orig = phi
        # emit-to-phi epsilon transition, except into a repeated label
        prev_phi = add_to_phi(phi, emit + log_epsilon * repeat)
        # phi-to-emit and emit self-loop
        next_emit = _logaddexp(prev_phi[:, :-1] + emit_lp[s], emit + emit_lp[s])
        # phi self-loop; emit-to-phi through a blank only into a repeat
        next_phi = add_to_phi(prev_phi + phi_lp[s],
                              emit + phi_lp[s] + log_epsilon * (1.0 - repeat))
        p = pad[s]
        emit = p * emit + (1.0 - p) * next_emit
        phi = p * prev_phi_orig + (1.0 - p) * next_phi
    phi = add_to_phi(phi, emit)  # the last epsilon transition
    return -phi.gather(1, label_lengths.long().to(logits.device)[:, None])[:, 0]
