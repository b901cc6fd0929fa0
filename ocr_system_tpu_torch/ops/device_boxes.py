"""On-device detection box statistics: prob map -> per-component stats
(port of ocr_system_tpu/ops/device_boxes.py).

Connected components by monotone label propagation to a fixpoint, exactly
as the reference rounds it: every foreground pixel starts with its own
linear index + 1; a round is six 3x3 max-pools (8-connectivity) then
segmented max-scans along rows and columns, forward and backward; the loop
stops when no label changed or after 64 rounds. The fixpoint labels every
pixel with 1 + the largest linear index in its component (the canonical
label), and the component's ROOT is the pixel whose own index that is.

Rows follow the reference's order: the K largest root indices, descending
(``lax.top_k``), so stats compare row for row. The per-component
reductions are scatter reductions; the reference's (N, K) one-hot
membership matmul exists only to avoid TPU scatter. Sums accumulate in
float64 (the reference's float32 matmul sums lose low bits of coordinate
sums on large components); the stats leave as float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# stats channel layout (keep ops/boxes.boxes_from_stats in sync):
# 0 count, 1 score_sum, 2 x0, 3 y0, 4 x1, 5 y1, 6 theta, 7 cx, 8 cy,
# 9 u0, 10 v0, 11 u1, 12 v1
STATS_CHANNELS = 13
MAX_ROUNDS = 64


def _segmented_max_scan(
    vals: torch.Tensor, background: torch.Tensor, dim: int, reverse: bool
) -> torch.Tensor:
    """Running max along ``dim`` that restarts at background pixels: with
    seg = cumsum(background) numbering the runs, seg * M + label of any
    earlier run lies below the current run's base, so a plain cummax over
    those keys is the segmented max. int64 keys: seg * M overflows int32 at
    the 1280 bucket."""
    m = vals.shape[-1] * vals.shape[-2] + 2
    if reverse:
        vals, background = vals.flip(dim), background.flip(dim)
    seg = torch.cumsum(background.to(torch.int64), dim=dim)
    run = torch.cummax(seg * m + vals, dim=dim).values - seg * m
    if reverse:
        run, background = run.flip(dim), background.flip(dim)
    return torch.where(background, torch.zeros_like(run), run)


def _one_round(labels: torch.Tensor, binary: torch.Tensor) -> torch.Tensor:
    bg = ~binary
    for _ in range(6):
        # labels < 2**24, exact in float32 (max_pool2d takes no int64);
        # the -inf padding of max_pool2d acts as the reference's 0 init
        pooled = F.max_pool2d(labels[:, None].float(), 3, 1, 1)[:, 0]
        labels = torch.where(binary, pooled.to(torch.int64), 0)
    labels = _segmented_max_scan(labels, bg, dim=2, reverse=False)
    labels = _segmented_max_scan(labels, bg, dim=2, reverse=True)
    labels = _segmented_max_scan(labels, bg, dim=1, reverse=False)
    labels = _segmented_max_scan(labels, bg, dim=1, reverse=True)
    return labels


def propagate_labels(binary: torch.Tensor, max_rounds: int = MAX_ROUNDS) -> torch.Tensor:
    """(B, H, W) bool -> int64 canonical labels (0 on background). The
    convergence test reads one flag per round back to the host."""
    b, h, w = binary.shape
    if h * w >= 2**24:
        raise ValueError("map too large: labels must stay exact in float32")
    idx = torch.arange(1, h * w + 1, device=binary.device).view(1, h, w)
    labels = torch.where(binary, idx, 0)
    for _ in range(max_rounds):
        new = _one_round(labels, binary)
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels


def component_stats(
    prob: torch.Tensor, bin_thresh: float, k: int = 256
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) float prob -> ((B, K, 13) float32 stats, (B,) int64 total
    component counts). Rows with count 0 are padding; geometry is in
    prob-map coordinates. A count above K means the rows are incomplete and
    the caller must fall back to the host path over the map."""
    b, h, w = prob.shape
    n = h * w
    dev = prob.device
    binary = prob > bin_thresh
    flat = propagate_labels(binary).view(b, n)
    idx = torch.arange(n, device=dev)
    root_mask = (flat > 0) & (flat == idx + 1)
    n_comps = root_mask.sum(dim=1)
    kk = min(k, n)
    root_idx = torch.topk(
        torch.where(root_mask, idx, -1), kk, dim=1
    ).values  # (B, kk) descending
    if kk < k:
        root_idx = F.pad(root_idx, (0, k - kk), value=-1)
    present = root_idx >= 0

    # label -> row (K = "no row": background or a component past the top K)
    row_of = torch.full((b, n + 1), k, dtype=torch.int64, device=dev)
    rows = torch.arange(k, device=dev).expand(b, k)
    row_of.scatter_(1, torch.where(present, root_idx + 1, 0), torch.where(present, rows, k))
    row_of[:, 0] = k
    pix_row = row_of.gather(1, flat)  # (B, N)
    bins = (pix_row + torch.arange(b, device=dev)[:, None] * (k + 1)).view(-1)
    nb = b * (k + 1)

    yy = (idx // w).to(torch.float64).repeat(b)
    xx = (idx % w).to(torch.float64).repeat(b)
    pf = prob.reshape(-1).to(torch.float64)

    def total(v):
        return torch.zeros(nb, dtype=torch.float64, device=dev).index_add_(0, bins, v)

    def extreme(v, how):
        fill = float("inf") if how == "amin" else float("-inf")
        out = torch.full((nb,), fill, dtype=torch.float64, device=dev)
        return out.scatter_reduce_(0, bins, v, how, include_self=True)

    counts = total(torch.ones_like(pf))
    safe = counts.clamp(min=1.0)
    cx = total(xx) / safe
    cy = total(yy) / safe
    dx = xx - cx[bins]
    dy = yy - cy[bins]
    mxx = total(dx * dx) / safe
    myy = total(dy * dy) / safe
    mxy = total(dx * dy) / safe
    theta = 0.5 * torch.atan2(2.0 * mxy, mxx - myy)
    ct, st = torch.cos(theta)[bins], torch.sin(theta)[bins]
    u = dx * ct + dy * st
    v = -dx * st + dy * ct
    stats = torch.stack(
        [
            counts, total(pf),
            extreme(xx, "amin"), extreme(yy, "amin"),
            extreme(xx, "amax"), extreme(yy, "amax"),
            theta, cx, cy,
            extreme(u, "amin"), extreme(v, "amin"),
            extreme(u, "amax"), extreme(v, "amax"),
        ],
        dim=-1,
    ).view(b, k + 1, STATS_CHANNELS)[:, :k]
    stats = torch.where(present[..., None], stats, torch.zeros_like(stats))
    return stats.float(), n_comps
