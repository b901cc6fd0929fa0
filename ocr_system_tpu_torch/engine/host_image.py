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
- ``resize_linear`` on float64 (the classical detector's skew estimate):
  float32 fractions, one fused multiply-add per axis.
- ``adaptive_threshold``: ``cv2.adaptiveThreshold`` with
  ``THRESH_BINARY_INV`` and a replicated border, for the Gaussian and the
  mean window, bit for bit (see the function).
- ``dilate``: ``cv2.dilate`` with a rectangle of ones, anchor at its centre.
- ``resize_bicubic_pil``: PIL's ``Image.resize`` with its default BICUBIC
  filter on uint8, bit for bit (see the function).
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch
from scipy import ndimage


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
    bit. A float64 (H, W) image takes ``_resize_linear_f64``."""
    nh, nw = out_hw
    h, w = img.shape[:2]
    if (nh, nw) == (h, w):
        return img.copy()
    if img.dtype == np.float64:
        return _resize_linear_f64(img, nh, nw)
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


def _float_taps(n_out: int, n_in: int):
    """OpenCV's INTER_LINEAR taps along one axis for float images: both
    source indices (clamped to the image) and the float32 fraction."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    i0 = np.floor(f)
    t = (f - i0).astype(np.float64)
    i0 = i0.astype(np.int64)
    return np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1), t


def _lerp_fma(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """a + (b - a) * t as a fused multiply-add (one rounding of product
    and sum), for a float32-valued t: b - a splits into two halves of 26
    bits whose products with t's 24 are exact, and the three terms are
    added with the error of the first sum carried. That equals the fused
    result unless the carried error's own rounding decides a tie, which
    no tested image showed."""
    d = b - a
    c = d * 134217729.0  # 2^27 + 1
    hi = c - (c - d)
    p, q = hi * t, (d - hi) * t
    s = a + p
    bb = s - a
    e = (a - (s - bb)) + (p - bb)
    return s + (e + q)


def _resize_linear_f64(img: np.ndarray, nh: int, nw: int) -> np.ndarray:
    """float64 (H, W) bilinear as ``cv2.resize`` computes it: rows first,
    each output a + (b - a) * t by a fused multiply-add with the float32
    fraction t; at the borders both taps read the edge pixel."""
    h, w = img.shape
    xa, xb, tx = _float_taps(nw, w)
    ya, yb, ty = _float_taps(nh, h)
    rows = _lerp_fma(img[:, xa], img[:, xb], tx[None, :])
    return _lerp_fma(rows[ya], rows[yb], ty[:, None])


_PIL_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed-point coefficients for 8-bit images


def _pil_bicubic(x: np.ndarray) -> np.ndarray:
    """PIL's bicubic filter (a = -0.5), support 2."""
    x = np.abs(x)
    a = -0.5
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's resampling taps along one axis (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``): per output pixel the first source index and
    the fixed-point weights of its taps (zero past the window's end). The
    filter's support widens by the scale when reducing; the window is
    rounded by C truncation, the weights normalised to sum 1 in float64 and
    rounded half away from zero to 22 fractional bits."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = _pil_bicubic((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) / filterscale)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    # PIL sums the weights in order and divides each by the (nonzero) sum
    ww = np.zeros(out_size)
    for k in range(ksize):
        ww += w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = w * (1 << _PIL_PRECISION_BITS)
    kk = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    return xmin, kk


def _pil_pass(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One separable pass of PIL's 8-bit resampling along ``axis``: integer
    sums from a half-unit start, shifted by 22 bits and clipped to 0..255."""
    xmin, kk = _pil_coeffs(img.shape[axis], out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size, *src.shape[1:]), 1 << (_PIL_PRECISION_BITS - 1), np.int64)
    extra = (1,) * (src.ndim - 1)
    for k in range(kk.shape[1]):
        idx = np.minimum(xmin + k, img.shape[axis] - 1)  # past the window the weight is 0
        acc += src[idx] * kk[:, k].reshape(-1, *extra)
    out = np.clip(acc >> _PIL_PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic_pil(img: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """uint8 (H, W[, C]) -> (nh, nw[, C]) as ``PIL.Image.resize(size)``
    writes it (BICUBIC, its default): the horizontal pass first, into
    uint8, then the vertical pass, each skipped where its size is kept."""
    nh, nw = out_hw
    out = img
    if nw != img.shape[1]:
        out = _pil_pass(out, 1, nw)
    if nh != img.shape[0]:
        out = _pil_pass(out, 0, nh)
    return np.ascontiguousarray(out)


def gaussian_kernel_f32(n: int) -> np.ndarray:
    """``cv2.getGaussianKernel(n, 0, cv2.CV_32F)`` for odd n > 9: sigma
    0.15 n + 0.35, the weights exp(-x^2 / (2 sigma^2)) normalised to sum 1,
    in float64, rounded to float32."""
    # OpenCV's bit-exact construction: sigma by one fused multiply-add, the
    # half sum accumulated in order
    sigma = float(Fraction(n) * Fraction(0.15) + Fraction(0.35))
    scale = -0.125 / (sigma * sigma)
    half = [math.exp(float(x * x) * scale) for x in range(1 - n, 0, 2)]
    total = 0.0
    for t in half:
        total += t
    mul = 1.0 / (total * 2.0 + 1.0)
    side = [t * mul for t in half]
    return np.array(side + [mul] + side[::-1], np.float32)


def _fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 fused multiply-add, correctly rounded: a * b is exact in
    float64; a sum that float64 rounds onto a float32 midpoint is moved
    one float64 step toward the exact value before the last rounding."""
    p = a.astype(np.float64) * b.astype(np.float64)
    c = c.astype(np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # s + err == p + c exactly
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.float32(np.inf), np.float32(-np.inf)))
    mid = (r.astype(np.float64) + other.astype(np.float64)) * 0.5
    tie = (s == mid) & (err != 0)
    if tie.any():
        s[tie] = np.nextafter(s[tie], np.where(err[tie] > 0, np.inf, -np.inf))
        r = s.astype(np.float32)
    return r


def _gaussian_exact(src: np.ndarray, k: np.ndarray, ys: np.ndarray,
                    xs: np.ndarray) -> np.ndarray:
    """OpenCV's float32 separable Gaussian (``sepFilter2D``, replicated
    border) at the pixels (ys, xs), with its rounding: rows first, the taps
    summed in order by fused multiply-adds where a row is processed in
    8- or 4-wide vectors and by a multiply and an add in the scalar tail;
    then columns, the taps paired symmetrically about the centre, fused
    where 8-wide and multiply-then-add past that."""
    h, w = src.shape
    r = len(k) // 2
    q8 = (w // 8) * 8
    q4 = q8 + 4 if q8 + 4 <= w else q8
    kf = k.astype(np.float32)
    rows = np.clip(ys[:, None] + np.arange(-r, r + 1)[None, :], 0, h - 1)  # (n, 2r+1)
    fused_row = np.broadcast_to((xs < q4)[:, None], rows.shape)
    acc = None
    for t in range(2 * r + 1):
        col = np.clip(xs - r + t, 0, w - 1)
        v = src[rows, col[:, None]].astype(np.float32)
        if acc is None:
            acc = v * kf[t]
            continue
        acc = np.where(fused_row, _fma32(v, kf[t], acc),
                       (acc + v * kf[t]).astype(np.float32))
    fused_col = xs < q8
    out = acc[:, r] * kf[r]
    for t in range(1, r + 1):
        pair = (acc[:, r + t] + acc[:, r - t]).astype(np.float32)
        out = np.where(fused_col, _fma32(pair, kf[r + t], out),
                       (out + pair * kf[r + t]).astype(np.float32))
    return out


# the float32 Gaussian of a u8 image is within ~5e-4 of the exact sum;
# pixels whose float64 sum lies closer than this to a rounding tie are
# recomputed with OpenCV's float32 arithmetic
_TIE_MARGIN = 1e-3


def adaptive_threshold(gray: np.ndarray, method: str, block: int = 31,
                       c: float = 15.0) -> np.ndarray:
    """(H, W) uint8 -> uint8 ink mask (1 where ``gray - local_mean <= -c``):
    ``cv2.adaptiveThreshold(gray, 255, ADAPTIVE_THRESH_{GAUSSIAN,MEAN}_C,
    THRESH_BINARY_INV, block, c) > 0`` bit for bit.

    ``"mean"``: the block's box sum with a replicated border, rounded to
    u8 (sum / block^2 is never a tie for odd block). ``"gaussian"``: OpenCV
    blurs a float32 copy with ``gaussian_kernel_f32(block)`` and rounds
    half to even. That blur is computed here in float64 and rounded; the
    pixels near a tie are recomputed with OpenCV's float32 operations
    (``_gaussian_exact``), so the rounded mean is OpenCV's."""
    gray = np.ascontiguousarray(gray, np.uint8)
    r = block // 2
    if method == "mean":
        ones = np.ones(block)
        box = ndimage.correlate1d(gray.astype(np.int32), ones, axis=1, mode="nearest")
        box = ndimage.correlate1d(box, ones, axis=0, mode="nearest")
        area = block * block
        mean = (2 * box + area) // (2 * area)
    elif method == "gaussian":
        k = gaussian_kernel_f32(block)
        k64 = k.astype(np.float64)
        blur = ndimage.correlate1d(gray.astype(np.float64), k64, axis=1, mode="nearest")
        blur = ndimage.correlate1d(blur, k64, axis=0, mode="nearest")
        mean = np.rint(blur)
        near = np.abs(blur - np.floor(blur) - 0.5) < _TIE_MARGIN
        ys, xs = np.nonzero(near)
        if len(ys):
            mean[ys, xs] = np.rint(_gaussian_exact(gray, k, ys, xs))
    else:
        raise ValueError(f"adaptive_threshold: unknown method {method!r}")
    return (gray.astype(np.int64) - mean.astype(np.int64) <= -math.floor(c)).astype(np.uint8)


def dilate(mask: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``cv2.dilate(mask, np.ones(size, np.uint8))``: the max over a
    (kh, kw) window whose anchor is (kh // 2, kw // 2), so an even side
    reaches one pixel further back than forward; outside the image counts
    as nothing."""
    return ndimage.maximum_filter(mask, size=size, mode="constant", cval=0)


def _cubic_weights(t: torch.Tensor) -> list[torch.Tensor]:
    """OpenCV's interpolateCubic (a = -0.75) at fractional offsets t."""
    a = -0.75
    c0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    c1 = ((a + 2) * t - (a + 3)) * t * t + 1
    c2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    return [c0, c1, c2, 1.0 - c0 - c1 - c2]


def rotation_params(h: int, w: int, angle_deg: float) -> tuple[float, float, float, float]:
    """``(alpha, beta, tx, ty)`` of the turn by ``angle_deg`` about
    (w/2, h/2): the forward map M = [[alpha, beta, tx], [-beta, alpha, ty]]
    is a rotation, so its inverse is the transpose with the shift undone.
    ``rotate_cubic`` and the rotate kernel (``kernels/rotate.py``) both
    sample with these."""
    a = math.radians(angle_deg)
    alpha, beta = math.cos(a), math.sin(a)
    cx, cy = w / 2.0, h / 2.0
    tx = (1 - alpha) * cx - beta * cy
    ty = beta * cx + (1 - alpha) * cy
    return alpha, beta, tx, ty


def rotate_cubic(page: np.ndarray, angle_deg: float, fill: int = 255) -> np.ndarray:
    """Rotate about (w/2, h/2) by ``angle_deg`` (counter-clockwise), same
    size, bicubic, constant ``fill`` border."""
    h, w = page.shape[:2]
    alpha, beta, tx, ty = rotation_params(h, w, angle_deg)
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
