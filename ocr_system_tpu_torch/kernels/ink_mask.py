"""The classical detector's ink mask as one CUDA kernel (``csrc/kernels.cu``
``ink_mask_kernel``): the page's float64 luma truncated to u8, OpenCV's
float32 Gaussian of it (block ``BLOCK``, replicated border) with OpenCV's
own rounding, the mean rounded half to even, and 1 where the luma lies
``C`` or more below the mean.

Replaces no Pallas kernel: the JAX package masks on the host with
``cv2.adaptiveThreshold``. The port's host version is
``classical_detector._ink_mask``, a float64 blur whose near-tie pixels are
recomputed with OpenCV's float32 operations. The plain version,
``ink_mask_pages_plain``, is the kernel's arithmetic on the whole page in
numpy (``host_image._fma32`` for the fused steps): it needs no tie repair,
because every pixel's mean is OpenCV's float32 value. So the kernel, the
plain version and the host mask agree bit for bit. The kernel is bound by
bytes and operations alike, a microsecond or two a 960² page; in the
detector the copies of the page up and the mask back bound the call. Its
note in the CUDA source says more.

On a CPU tensor ``ink_mask_pages`` runs the plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ocr_system_tpu_torch.engine.host_image import _fma32, gaussian_kernel_f32
from ocr_system_tpu_torch.kernels import _build
from ocr_system_tpu_torch.utils.profiler import count

LAUNCHES = _build.LaunchCounter()
BLOCK = 31  # the Gaussian's taps (the kernel's radius, 15, is compiled in)
C = 15  # ink where luma - mean <= -C
TAPS = gaussian_kernel_f32(BLOCK)  # float32, read by the launcher from host memory


def _gaussian_f32(gray: np.ndarray) -> np.ndarray:
    """OpenCV's float32 Gaussian of a u8 (H, W) image with its rounding at
    every pixel: the rule of ``host_image._gaussian_exact`` (rows fused
    below q4, columns fused below q8, multiply-then-add past them)."""
    h, w = gray.shape
    k, r = TAPS, BLOCK // 2
    q8 = w // 8 * 8
    q4 = q8 + 4 if q8 + 4 <= w else q8
    src = gray.astype(np.float32)[:, np.clip(np.arange(-r, w + r), 0, w - 1)]
    acc = src[:, :w] * k[0]
    for t in range(1, BLOCK):
        v = src[:, t:t + w]
        acc[:, :q4] = _fma32(v[:, :q4], k[t], acc[:, :q4])
        acc[:, q4:] += v[:, q4:] * k[t]
    rows = acc[np.clip(np.arange(-r, h + r), 0, h - 1)]
    mean = rows[r:r + h] * k[r]
    for t in range(1, r + 1):
        pair = rows[r + t:r + t + h] + rows[r - t:r - t + h]
        mean[:, :q8] = _fma32(pair[:, :q8], k[r + t], mean[:, :q8])
        mean[:, q8:] += pair[:, q8:] * k[r + t]
    return mean


def ink_mask_pages_plain(page: torch.Tensor) -> torch.Tensor:
    """Plain version of ``ink_mask_pages``, on the host."""
    p = page.numpy()
    r, g, b = (p[..., i].astype(np.float64) for i in range(3))
    gray = ((0.299 * r + 0.587 * g) + 0.114 * b).astype(np.uint8)
    mean = np.rint(_gaussian_f32(gray)).astype(np.int32)
    return torch.from_numpy((gray.astype(np.int32) - mean <= -C).astype(np.uint8))


def ink_mask_pages(page: torch.Tensor) -> torch.Tensor:
    """page (H, W, 3) uint8 RGB -> (H, W) uint8 ink mask, 1 = ink:
    ``classical_detector._ink_mask`` of it. On the card one launch, and the
    call counts ``mask.card_pages`` on the innermost recorded span."""
    if page.dtype != torch.uint8 or page.dim() != 3 or page.shape[2] != 3:
        raise ValueError(f"ink_mask_pages: expected a (H, W, 3) torch.uint8 page, got "
                         f"{page.dtype} {tuple(page.shape)}")
    if page.device.type == "cpu":
        return ink_mask_pages_plain(page)
    if page.device.type != "cuda":
        raise ValueError(f"ink_mask_pages: no kernel for a {page.device.type} tensor")
    if not page.is_contiguous():
        raise ValueError("ink_mask_pages: the page is not contiguous")
    h, w, _ = page.shape
    if h == 0 or w == 0 or page.numel() >= 2**31:
        raise ValueError(f"ink_mask_pages: {tuple(page.shape)} is empty or too large for "
                         "32-bit offsets")
    out = torch.empty((h, w), dtype=torch.uint8, device=page.device)
    lib = _build.library()
    with torch.cuda.device(page.device):  # the launch goes to the current card
        stream = torch.cuda.current_stream(page.device).cuda_stream
        rc = lib.ocr_ink_mask(page.data_ptr(), out.data_ptr(), TAPS.ctypes.data, h, w, C,
                              stream)
        _build.check(rc, "ink_mask")
        LAUNCHES.add()
    count("mask.card_pages")
    return out
