"""Host-side image helpers with OpenCV's semantics, without OpenCV (the
JAX package calls cv2 for these in engine/detector.py and
engine/recognizer.py).

- ``resize_linear``: ``cv2.resize(..., INTER_LINEAR)`` on uint8, bit for
  bit — half-pixel centres, no antialias, source indices clamped at the
  borders, OpenCV's 11-bit fixed-point weights and shifts.
- ``rotate_cubic``: ``cv2.warpAffine`` of ``cv2.getRotationMatrix2D`` with
  ``INTER_CUBIC`` (a = -0.75) and a white constant border; OpenCV 5 samples
  at float coordinates with float weights, as this does.
- ``rgb_to_gray``: ``cv2.COLOR_RGB2GRAY`` for uint8, its 15-bit fixed point.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def rgb_to_gray(page: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 luma; (H, W) passes through."""
    if page.ndim == 2:
        return page
    p = page.astype(np.int32)
    y = p[..., 0] * 9798 + p[..., 1] * 19235 + p[..., 2] * 3735 + (1 << 14)
    return (y >> 15).astype(np.uint8)


def _linear_taps(n_out: int, n_in: int):
    """OpenCV's INTER_LINEAR taps along one axis: both source indices and
    their 11-bit weights. The fraction is kept even where both taps clamp
    to one border index: the vertical pass truncates its two terms
    separately, so it shows there."""
    scale = 1.0 / (n_out / n_in)
    s = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(s)
    f = (s - i0).astype(np.float32)
    i0 = i0.astype(np.int64)
    w1 = np.rint(f * np.float32(2048)).astype(np.int32)
    w0 = np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int32)
    return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), w0, w1


def resize_linear(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """uint8 (H, W[, C]) -> (nh, nw[, C]) bilinear in OpenCV's fixed point:
    rows first in int32 with 11-bit weights, then columns, each term
    shifted as ``cv2.resize`` shifts it, so the result equals it bit for
    bit."""
    nh, nw = out_hw
    h, w = img.shape[:2]
    if (nh, nw) == (h, w):
        return img.copy()
    ya, yb, v0, v1 = _linear_taps(nh, h)
    xa, xb, u0, u1 = _linear_taps(nw, w)
    extra = (1,) * (img.ndim - 2)
    rows = np.unique(np.concatenate([ya, yb]))  # only the rows sampled
    src = img[rows].astype(np.int32)
    r = np.take(src, xa, axis=1)
    r *= u0.reshape(1, -1, *extra)
    rb = np.take(src, xb, axis=1)
    rb *= u1.reshape(1, -1, *extra)
    r += rb
    r >>= 4
    top = np.take(r, np.searchsorted(rows, ya), axis=0)
    top *= v0.reshape(-1, 1, *extra)
    top >>= 16
    bot = np.take(r, np.searchsorted(rows, yb), axis=0)
    bot *= v1.reshape(-1, 1, *extra)
    bot >>= 16
    top += bot
    top += 2
    top >>= 2
    return np.clip(top, 0, 255).astype(np.uint8)


def _cubic_weights(t: torch.Tensor) -> list[torch.Tensor]:
    """OpenCV's interpolateCubic (a = -0.75) at fractional offsets t."""
    a = -0.75
    c0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    c1 = ((a + 2) * t - (a + 3)) * t * t + 1
    c2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    return [c0, c1, c2, 1.0 - c0 - c1 - c2]


def rotate_cubic(page: np.ndarray, angle_deg: float, fill: int = 255) -> np.ndarray:
    """Rotate about (w/2, h/2) by ``angle_deg`` (counter-clockwise), same
    size, bicubic, constant ``fill`` border."""
    h, w = page.shape[:2]
    a = math.radians(angle_deg)
    alpha, beta = math.cos(a), math.sin(a)
    cx, cy = w / 2.0, h / 2.0
    # the forward map M = [[alpha, beta, tx], [-beta, alpha, ty]] is a
    # rotation, so its inverse is the transpose with the shift undone
    tx = (1 - alpha) * cx - beta * cy
    ty = beta * cx + (1 - alpha) * cy
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float64),
        torch.arange(w, dtype=torch.float64), indexing="ij",
    )
    sx = alpha * (xs - tx) - beta * (ys - ty)
    sy = beta * (xs - tx) + alpha * (ys - ty)
    ix, iy = torch.floor(sx), torch.floor(sy)
    wx, wy = _cubic_weights(sx - ix), _cubic_weights(sy - iy)
    ix, iy = ix.long(), iy.long()

    chan = page.shape[2] if page.ndim == 3 else 1
    # flat source with one extra row holding the border value: an
    # out-of-page tap indexes it
    src = torch.from_numpy(np.ascontiguousarray(page)).reshape(h * w, chan)
    src = torch.cat([src, torch.full((1, chan), fill, dtype=src.dtype)])
    src = src.to(torch.float64)
    acc = torch.zeros((h * w, chan), dtype=torch.float64)
    for k1 in range(4):
        yy = iy + (k1 - 1)
        for k2 in range(4):
            xx = ix + (k2 - 1)
            inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            lin = torch.where(inside, yy * w + xx, h * w).reshape(-1)
            acc += src.index_select(0, lin) * (wy[k1] * wx[k2]).reshape(-1, 1)
    out = torch.round(acc).clamp(0, 255).to(torch.uint8).reshape(page.shape)
    return out.numpy()
