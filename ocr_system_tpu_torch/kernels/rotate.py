"""The detector's deskew turn as one CUDA kernel (``csrc/kernels.cu``
``rotate_kernel``): each page turned about its centre by its own angle,
bicubic (OpenCV's a = -0.75), constant border.

Replaces no Pallas kernel: the JAX package turns skewed pages on the host
with ``cv2.warpAffine``. The plain version is ``engine/host_image.
rotate_cubic`` (float64 PyTorch ops on the whole page), and the kernel
repeats its float64 arithmetic operation for operation, so the two agree
bit for bit. The kernel itself is bound by float64 operations; in the
detector the turn is bound by the PCIe copies of the pages around it (the
turned page is read on the host). Its note in the CUDA source says more.

On a CPU tensor ``rotate_pages`` runs the plain version; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from ocr_system_tpu_torch.engine.host_image import rotate_cubic, rotation_params
from ocr_system_tpu_torch.kernels import _build
from ocr_system_tpu_torch.utils.profiler import count

LAUNCHES = _build.LaunchCounter()
CHANNELS = (1, 3)
MAX_PAGES = 64  # pages a launch (their parameters ride in its arguments)


def rotate_pages_plain(pages: torch.Tensor, angles: Sequence[float],
                       fill: int = 255) -> torch.Tensor:
    """Plain version of ``rotate_pages``: ``rotate_cubic`` page by page."""
    return torch.stack([torch.from_numpy(rotate_cubic(p.numpy(), float(a), fill))
                        for p, a in zip(pages, angles, strict=True)])


def rotate_pages(pages: torch.Tensor, angles: Sequence[float], fill: int = 255) -> torch.Tensor:
    """pages (B, H, W, C) uint8, C 1 or 3, and one angle in degrees
    (counter-clockwise) per page -> the pages turned about (W/2, H/2), same
    size, bicubic, ``fill`` outside: ``rotate_cubic`` of each page. On the
    card one launch turns up to MAX_PAGES pages, and the call counts
    ``turn.card_pages`` on the innermost recorded span."""
    if not 0 <= fill <= 255:
        raise ValueError(f"rotate_pages: fill {fill} is not a u8 value")
    if pages.device.type == "cpu":
        return rotate_pages_plain(pages, angles, fill)
    if pages.dtype != torch.uint8 or pages.dim() != 4 or not pages.is_contiguous():
        raise ValueError(
            "rotate_pages: expected a contiguous torch.uint8 tensor of 4 dims, got "
            f"{pages.dtype} {tuple(pages.shape)} contiguous={pages.is_contiguous()}"
        )
    b, h, w, c = pages.shape
    if len(angles) != b:
        raise ValueError(f"rotate_pages: {len(angles)} angles for {b} pages")
    if c not in CHANNELS:
        raise ValueError(f"rotate_pages: {c} channels; the kernel takes {CHANNELS}")
    if pages.numel() >= 2**31:
        raise ValueError(f"rotate_pages: {tuple(pages.shape)} is too large for 32-bit offsets")
    out = torch.empty_like(pages)
    params = np.array([rotation_params(h, w, float(a)) for a in angles], np.float64)
    lib = _build.library()
    page_bytes = h * w * c
    with torch.cuda.device(pages.device):  # the launch goes to the current card
        stream = torch.cuda.current_stream(pages.device).cuda_stream
        for k in range(0, b, MAX_PAGES):
            n = min(MAX_PAGES, b - k)
            # the parameters travel in the launch's arguments, not by a copy
            rc = lib.ocr_rotate(pages.data_ptr() + k * page_bytes, out.data_ptr() + k * page_bytes,
                                params[k:k + n].ctypes.data, n, h, w, c, fill, stream)
            _build.check(rc, "rotate")
            LAUNCHES.add()
    count("turn.card_pages", b)
    return out
