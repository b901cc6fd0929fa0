"""Bilinear crops for the recognizer (port of the rec-path half of
ocr_system_tpu/ops/sampling.py).

Conventions: images are (H, W) float tensors; coordinates are (x, y) with x
along the width. ``crop_quads`` zero-fills outside the page;
``crop_boxes_separable`` clamps (border replication). The axis-aligned crop
that the recognizer runs is the CUDA kernel in kernels/crop.py; these two
are the general quad path and the JAX package's separable reference.
"""

from __future__ import annotations

import numpy as np
import torch


def _gather_bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W) at float coords x, y (same shape); out-of-range
    reads clamp to the border pixel."""
    h, w = img.shape
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = x - x0
    dy = y - y0
    x0i = x0.long().clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    y0i = y0.long().clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    v00 = img[y0i, x0i]
    v01 = img[y0i, x1i]
    v10 = img[y1i, x0i]
    v11 = img[y1i, x1i]
    top = v00 * (1.0 - dx) + v01 * dx
    bot = v10 * (1.0 - dx) + v11 * dx
    return top * (1.0 - dy) + bot * dy


def quad_rectify_matrix(quads: torch.Tensor, out_shape: tuple[int, int]) -> torch.Tensor:
    """(N, 4, 2) quads (tl, tr, br, bl) -> (N, 2, 3) affine maps from an
    (out_h, out_w) grid onto each quad's parallelogram (tl->tr, tl->bl)."""
    out_h, out_w = out_shape
    tl, tr, bl = quads[:, 0], quads[:, 1], quads[:, 3]
    ex = (tr - tl) / max(out_w - 1, 1)
    ey = (bl - tl) / max(out_h - 1, 1)
    return torch.stack([ex, ey, tl], dim=-1)  # rows x, y


def crop_quads(img: torch.Tensor, quads: torch.Tensor,
               out_shape: tuple[int, int]) -> torch.Tensor:
    """Rotated-rect crop+rectify: img (H, W), quads (N, 4, 2) ->
    (N, out_h, out_w), zero outside the page."""
    out_h, out_w = out_shape
    h, w = img.shape
    m = quad_rectify_matrix(quads.float(), out_shape)  # (N, 2, 3)
    ys = torch.arange(out_h, dtype=torch.float32, device=img.device)
    xs = torch.arange(out_w, dtype=torch.float32, device=img.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    x_in = m[:, 0, 0, None, None] * gx + m[:, 0, 1, None, None] * gy + m[:, 0, 2, None, None]
    y_in = m[:, 1, 0, None, None] * gx + m[:, 1, 1, None, None] * gy + m[:, 1, 2, None, None]
    sampled = _gather_bilinear(img, x_in, y_in)
    inside = (x_in >= 0) & (x_in <= w - 1) & (y_in >= 0) & (y_in <= h - 1)
    return torch.where(inside, sampled, torch.zeros_like(sampled))


def crop_boxes_separable(img: torch.Tensor, boxes: torch.Tensor,
                         out_shape: tuple[int, int]) -> torch.Tensor:
    """Axis-aligned crop+resize: (N, 4) [x0,y0,x1,y1] -> (N, h, w), floor
    indices clamped into the page (the JAX package's non-TPU path)."""
    out_h, out_w = out_shape
    h, w = img.shape
    lin_h = torch.linspace(0.0, 1.0, out_h, device=img.device)
    lin_w = torch.linspace(0.0, 1.0, out_w, device=img.device)
    x0, y0, x1, y1 = boxes.float().unbind(-1)
    ys = y0[:, None] + (y1 - y0)[:, None] * lin_h
    xs = x0[:, None] + (x1 - x0)[:, None] * lin_w
    yf, xf = torch.floor(ys), torch.floor(xs)
    dy, dx = (ys - yf)[:, :, None], (xs - xf)[:, None, :]
    y0i = yf.long().clamp(0, h - 1)
    y1i = (y0i + 1).clamp(0, h - 1)
    x0i = xf.long().clamp(0, w - 1)
    x1i = (x0i + 1).clamp(0, w - 1)
    rows = img[y0i] * (1 - dy) + img[y1i] * dy  # (N, out_h, W)
    left = rows.gather(2, x0i[:, None, :].expand(-1, out_h, -1))
    right = rows.gather(2, x1i[:, None, :].expand(-1, out_h, -1))
    return left * (1 - dx) + right * dx


def axis_aligned_mask(quads, tol_ratio: float = 0.15) -> np.ndarray:
    """Host check: per quad, does it deviate from its AABB by less than
    tol_ratio of its height? -> (N,) bool."""
    quads = np.asarray(quads)
    if len(quads) == 0:
        return np.zeros((0,), bool)
    heights = np.maximum(
        quads[:, :, 1].max(axis=1) - quads[:, :, 1].min(axis=1), 1.0
    )
    top_dev = np.abs(quads[:, 0, 1] - quads[:, 1, 1])
    side_dev = np.abs(quads[:, 0, 0] - quads[:, 3, 0])
    return np.maximum(top_dev, side_dev) <= tol_ratio * heights


def quads_are_axis_aligned(quads, tol_ratio: float = 0.15) -> bool:
    """Host check: do ALL quads deviate from their AABBs by less than
    tol_ratio of their height?"""
    return bool(axis_aligned_mask(quads, tol_ratio).all())


def quads_to_aabbs(quads) -> np.ndarray:
    """(N, 4, 2) -> (N, 4) [x0, y0, x1, y1] float32 (host)."""
    quads = np.asarray(quads)
    return np.stack(
        [
            quads[:, :, 0].min(axis=1),
            quads[:, :, 1].min(axis=1),
            quads[:, :, 0].max(axis=1),
            quads[:, :, 1].max(axis=1),
        ],
        axis=1,
    ).astype(np.float32)
