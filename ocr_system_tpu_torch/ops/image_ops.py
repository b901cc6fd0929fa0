"""The page preprocessing chain as tensor ops (port of
ocr_system_tpu/ops/image_ops.py): resize and letterbox, enhancement,
median denoise, adaptive binarization, skew estimation and deskew, and the
whole chain (``preprocess_page``, the reference's preprocess_for_azure
minus its codec steps).

Images are float32 in [0, 1]: (H, W) gray or (H, W, 3) RGB (channel last),
as in the JAX module. ``estimate_skew_angle`` takes a batch (B, H, W) of
gray pages. Everything runs wherever its input lies.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ocr_system_tpu_torch.ops.sampling import rotate

# ImageNet-ish normalization used by the det/rec models (PP-OCR convention).
NORM_MEAN = (0.485, 0.456, 0.406)
NORM_STD = (0.229, 0.224, 0.225)


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB [0,1] -> (H, W) luma; (H, W) passes through."""
    if img.dim() == 2:
        return img
    # elementwise in a fixed order, so every device rounds it alike (a
    # matmul's order is the library's)
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """(H, W[, C]) -> (out_h, out_w[, C]) bilinear with half-pixel centres,
    antialiased when downscaling (the triangle kernel widened by the
    scale), as ``jax.image.resize(method="bilinear")``."""
    x = img[None, None] if img.dim() == 2 else img.permute(2, 0, 1)[None]
    out = F.interpolate(x.float(), size=tuple(out_hw), mode="bilinear",
                        align_corners=False, antialias=True)[0]
    return out[0] if img.dim() == 2 else out.permute(1, 2, 0)


def letterbox(img: torch.Tensor, target_hw: tuple[int, int],
              fill: float = 0.0) -> tuple[torch.Tensor, float]:
    """Aspect-preserving resize into a (target_h, target_w) canvas, top-left
    anchored, padded with ``fill``. Returns (canvas, scale)."""
    th, tw = target_hw
    h, w = img.shape[0], img.shape[1]
    scale = min(th / h, tw / w)
    nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    resized = resize_bilinear(img, (nh, nw))
    canvas = torch.full((th, tw, *img.shape[2:]), fill, dtype=resized.dtype,
                        device=resized.device)
    canvas[:nh, :nw] = resized
    return canvas, scale


def gaussian_kernel1d(sigma: float, radius: int) -> torch.Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def blur_planes(planes: torch.Tensor, sigma: float = 1.0, radius: int = 2) -> torch.Tensor:
    """Separable Gaussian blur over the last two axes of (..., H, W),
    rows first, edge-replicated borders (the JAX module's
    jnp.pad(mode="edge")), as weighted sums of shifted views: no
    convolution, so no TF32 on the card."""
    k = gaussian_kernel1d(sigma, radius).tolist()
    h, w = planes.shape[-2:]
    flat = planes.reshape(-1, 1, h, w)
    p = F.pad(flat, (radius, radius, radius, radius), mode="replicate")
    rows = sum(k[i] * p[..., i:i + h, :] for i in range(len(k)))
    blur = sum(k[i] * rows[..., :, i:i + w] for i in range(len(k)))
    return blur.reshape(planes.shape)


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None) -> torch.Tensor:
    """Separable Gaussian blur of (H, W) (or of the last two axes), edge
    replicated (cv2's BORDER_REPLICATE); the radius defaults to
    round(3 sigma), at least 1."""
    if radius is None:
        radius = max(int(3.0 * sigma + 0.5), 1)
    return blur_planes(img, sigma, radius)


def enhance_contrast(img: torch.Tensor, factor: float = 1.2) -> torch.Tensor:
    """PIL ImageEnhance.Contrast semantics: blend with the mean-gray image.
    The mean accumulates in float64, so that every device rounds it to the
    same float32 (a float32 sum's order is the device's)."""
    mean = to_grayscale(img).double().mean().float()
    return torch.clamp(mean + (img - mean) * factor, 0.0, 1.0)


def enhance_sharpness(img: torch.Tensor, factor: float = 1.1) -> torch.Tensor:
    """Unsharp-mask blend with a 5-tap (sigma 1) Gaussian, per channel."""
    if img.dim() == 2:
        blurred = blur_planes(img)
    else:
        blurred = blur_planes(img.permute(2, 0, 1)).permute(1, 2, 0)
    return torch.clamp(blurred + (img - blurred) * factor, 0.0, 1.0)


def median_denoise3(img: torch.Tensor) -> torch.Tensor:
    """3x3 median filter of the gray image, edge-replicated borders (the
    reference's MedianFilter(3)): the middle of the 9 shifted copies."""
    g = to_grayscale(img)
    h, w = g.shape
    p = F.pad(g[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    shifts = torch.stack([p[dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)])
    return torch.sort(shifts, dim=0).values[4]


def adaptive_binarize(img: torch.Tensor, block_size: int = 11,
                      c: float = 2.0 / 255.0) -> torch.Tensor:
    """Gaussian adaptive threshold, as cv2.adaptiveThreshold(
    ADAPTIVE_THRESH_GAUSSIAN_C, blockSize=11, C=2): a pixel is 1 where it is
    brighter than its local Gaussian mean less C, else 0. The sigma follows
    cv2's rule for a kernel size, 0.3 ((k - 1) / 2 - 1) + 0.8."""
    g = to_grayscale(img)
    radius = block_size // 2
    sigma = 0.3 * ((block_size - 1) * 0.5 - 1) + 0.8
    local_mean = gaussian_blur(g, sigma, radius)
    return (g > local_mean - c).to(g.dtype)


def normalize_for_model(
    img: torch.Tensor,
    mean: Sequence[float] = NORM_MEAN,
    std: Sequence[float] = NORM_STD,
) -> torch.Tensor:
    """(H, W[,3]) [0,1] -> model input (H, W, 3) normalized."""
    if img.dim() == 2:
        img = torch.stack([img] * 3, dim=-1)
    m = torch.tensor(mean, dtype=img.dtype, device=img.device)
    s = torch.tensor(std, dtype=img.dtype, device=img.device)
    return (img - m) / s


def skew_candidates(max_angle: float = 15.0, num_angles: int = 31) -> np.ndarray:
    """(2, num_angles) float32 host table: the skew search's candidate
    angles (degrees) and their tangents, equal to what the JAX module's
    ``jnp.linspace(-max_angle, max_angle, num_angles)`` and
    ``jnp.tan(jnp.deg2rad(.))`` give compiled.

    The angles follow JAX's ``_linspace`` as XLA compiles it with constant
    ends: the division by ``div = num_angles - 1`` becomes a product with
    the float32 reciprocal, and ``stop * (iota * r)`` is reassociated into
    ``iota * (stop * r)``, so ``angle_i = start * (1 - i*r) + i * (stop*r)``
    in float32, with ``stop`` appended. torch's and numpy's linspace round
    differently (15 of the 31 default candidates: 4.000001 against 4).
    The radians are the float32 product with pi/180, as ``jnp.deg2rad``;
    their tangent is taken in float64 and rounded once, which equals XLA's
    float32 ``tan`` at every default candidate (torch's float32 ``tan``
    misses one by an ulp). Other grids can differ from XLA's compiled chain
    by a few ulps in a tangent (45 degrees over 91 candidates: up to 36);
    only the scores read the tangents. The table is built here and not by
    device ops, whose elementwise rounding is the device's own."""
    f32 = np.float32
    start, stop = f32(-max_angle), f32(max_angle)
    inv = f32(1) / f32(num_angles - 1)
    i = np.arange(num_angles - 1, dtype=f32)
    angles = np.append(start * (f32(1) - i * inv) + i * (stop * inv), stop).astype(f32)
    rad = angles * f32(math.pi / 180.0)
    tans = np.tan(rad.astype(np.float64)).astype(f32)
    return np.stack([angles, tans])


def skew_search(
    pages: torch.Tensor,
    num_angles: int = 31,
    max_angle: float = 15.0,
    downsample_to: int = 256,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) gray pages in [0, 1] -> the skew search's (A,) candidate
    angles (degrees) and (B, A) scores, on the pages' device.

    The FFT shear-projection search of the JAX module: for small angles the
    rotated page's row profile is the profile after a per-column vertical
    shift x*tan(theta); by the shift theorem that is a per-frequency phase,
    and by Parseval the profile's variance is the summed power over the
    line-frequency band (|k| >= 8). The downsample is antialiased bilinear,
    as ``jax.image.resize`` is. The candidates and their tangents are
    ``skew_candidates``' host table, so a page's angle is the JAX module's
    float32 value bit for bit whenever both pick the same candidate.
    """
    n = downsample_to
    small = F.interpolate(
        pages[:, None].float(), size=(n, n), mode="bilinear",
        align_corners=False, antialias=True,
    )[:, 0]
    ink = (small < small.mean(dim=(1, 2), keepdim=True)).float()
    f = torch.fft.fft(ink, dim=1)  # (B, k, x): FFT over rows
    dev = pages.device
    angles, tans = torch.from_numpy(skew_candidates(max_angle, num_angles)).to(dev)
    k = torch.fft.fftfreq(n, device=dev) * n
    x = torch.arange(n, dtype=torch.float32, device=dev) - (n - 1) / 2.0
    phi = (-2.0 * math.pi / n) * (
        tans[:, None, None] * k[None, :, None] * x[None, None, :]
    )
    phase = torch.complex(torch.cos(phi), torch.sin(phi))  # (A, k, x)
    g_ak = torch.einsum("bkx,akx->bak", f, phase)
    power = g_ak.abs() ** 2
    kmask = (k.abs() >= 8.0).float()
    return angles, (power * kmask).sum(dim=-1)


def estimate_skew_angle(
    pages: torch.Tensor,
    num_angles: int = 31,
    max_angle: float = 15.0,
    downsample_to: int = 256,
) -> torch.Tensor:
    """(B, H, W) gray pages in [0, 1] -> (B,) correcting rotation in degrees
    (0 when no candidate angle beats 0 decisively): ``skew_search``'s best
    candidate, negated, where it beats the 0-degree score by the JAX
    module's angle-scaled margin."""
    angles, score = skew_search(pages, num_angles, max_angle, downsample_to)
    best = score.argmax(dim=1)
    score0 = score[:, num_angles // 2]
    best_angle = angles[best]
    required = 1.0 + 0.05 * best_angle.abs()
    confident = score.gather(1, best[:, None])[:, 0] > required * score0
    return torch.where(confident, -best_angle, torch.zeros_like(best_angle))


def deskew(img: torch.Tensor, min_angle: float = 0.5, max_angle: float = 45.0,
           fill_value: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """Deskew with the reference's gate: |angle| < 0.5 degrees is a no-op,
    |angle| > 45 is rejected (likely a mis-detection); otherwise the page
    turns by the estimated correcting angle. Returns (image, applied angle
    as a float32 scalar tensor). The gate is read on the host (one sync),
    so a straight page skips the rotation, as the JAX module's lax.cond."""
    angle = estimate_skew_angle(to_grayscale(img)[None])[0]
    apply = bool(((angle.abs() >= min_angle) & (angle.abs() <= max_angle)).item())
    if not apply:
        return img, torch.zeros((), dtype=torch.float32, device=img.device)
    return rotate(img, angle, fill_value=fill_value), angle


def preprocess_page(img: torch.Tensor, enable_deskew: bool = True,
                    enable_contrast: bool = True,
                    enable_binarize: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The on-device enhancement chain on one page (the reference's
    preprocess_for_azure minus the codec steps): deskew, then contrast 1.2
    and sharpness 1.1, then adaptive binarization, each where its flag is
    on. Returns (enhanced [0, 1] image, skew angle)."""
    angle = torch.zeros((), dtype=torch.float32, device=img.device)
    if enable_deskew:
        img, angle = deskew(img)
    if enable_contrast:
        img = enhance_contrast(img, 1.2)
        img = enhance_sharpness(img, 1.1)
    if enable_binarize:
        img = adaptive_binarize(img)
    return img, angle
