"""Page enhancement and skew estimation as tensor ops (port of the det-path
half of ocr_system_tpu/ops/image_ops.py).

Images are float32 in [0, 1]: (H, W) gray or (H, W, 3) RGB, as in the JAX
module. ``estimate_skew_angle`` takes a batch (B, H, W) of gray pages and
runs wherever its input lies.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

# ImageNet-ish normalization used by the det/rec models (PP-OCR convention).
NORM_MEAN = (0.485, 0.456, 0.406)
NORM_STD = (0.229, 0.224, 0.225)


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) RGB [0,1] -> (H, W) luma; (H, W) passes through."""
    if img.dim() == 2:
        return img
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    return img @ w


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


def enhance_contrast(img: torch.Tensor, factor: float = 1.2) -> torch.Tensor:
    """PIL ImageEnhance.Contrast semantics: blend with the mean-gray image."""
    mean = to_grayscale(img).mean()
    return torch.clamp(mean + (img - mean) * factor, 0.0, 1.0)


def enhance_sharpness(img: torch.Tensor, factor: float = 1.1) -> torch.Tensor:
    """Unsharp-mask blend with a 5-tap (sigma 1) Gaussian, per channel."""
    if img.dim() == 2:
        blurred = blur_planes(img)
    else:
        blurred = blur_planes(img.permute(2, 0, 1)).permute(1, 2, 0)
    return torch.clamp(blurred + (img - blurred) * factor, 0.0, 1.0)


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


def estimate_skew_angle(
    pages: torch.Tensor,
    num_angles: int = 31,
    max_angle: float = 15.0,
    downsample_to: int = 256,
) -> torch.Tensor:
    """(B, H, W) gray pages in [0, 1] -> (B,) correcting rotation in degrees
    (0 when no candidate angle beats 0 decisively).

    The FFT shear-projection search of the JAX module: for small angles the
    rotated page's row profile is the profile after a per-column vertical
    shift x*tan(theta); by the shift theorem that is a per-frequency phase,
    and by Parseval the profile's variance is the summed power over the
    line-frequency band (|k| >= 8). The downsample is antialiased bilinear,
    as ``jax.image.resize`` is.
    """
    n = downsample_to
    small = F.interpolate(
        pages[:, None].float(), size=(n, n), mode="bilinear",
        align_corners=False, antialias=True,
    )[:, 0]
    ink = (small < small.mean(dim=(1, 2), keepdim=True)).float()
    f = torch.fft.fft(ink, dim=1)  # (B, k, x): FFT over rows
    dev = pages.device
    angles = torch.linspace(-max_angle, max_angle, num_angles, device=dev)
    tans = torch.tan(torch.deg2rad(angles))
    k = torch.fft.fftfreq(n, device=dev) * n
    x = torch.arange(n, dtype=torch.float32, device=dev) - (n - 1) / 2.0
    phi = (-2.0 * math.pi / n) * (
        tans[:, None, None] * k[None, :, None] * x[None, None, :]
    )
    phase = torch.complex(torch.cos(phi), torch.sin(phi))  # (A, k, x)
    g_ak = torch.einsum("bkx,akx->bak", f, phase)
    power = g_ak.abs() ** 2
    kmask = (k.abs() >= 8.0).float()
    score = (power * kmask).sum(dim=-1)  # (B, A)
    best = score.argmax(dim=1)
    score0 = score[:, num_angles // 2]
    best_angle = angles[best]
    required = 1.0 + 0.05 * best_angle.abs()
    confident = score.gather(1, best[:, None])[:, 0] > required * score0
    return torch.where(confident, -best_angle, torch.zeros_like(best_angle))
