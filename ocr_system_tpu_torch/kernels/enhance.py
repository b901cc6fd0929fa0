"""Fused page enhancement: contrast -> 5-tap Gaussian unsharp -> ImageNet
normalisation, as one CUDA kernel (``csrc/kernels.cu`` ``enhance_kernel``).

Replaces ocr_system_tpu/kernels/preprocess_pallas.py::fused_enhance. The
kernel is bound by device-memory bytes (one read per input element, one
write per output element); its note in the CUDA source says how the
design keeps the stencil's reuse in shared memory. The per-image luma
mean is a separate reduction before the launch, as the TPU kernel leaves
it to XLA.

On a CPU tensor each wrapper runs the plain PyTorch version below; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ocr_system_tpu_torch.kernels import _build
from ocr_system_tpu_torch.ops import image_ops
from ocr_system_tpu_torch.ops.image_ops import NORM_MEAN, NORM_STD

LAUNCHES = _build.LaunchCounter()
CONTRAST = 1.2
SHARPNESS = 1.1


def gauss5() -> tuple[float, ...]:
    """The 5-tap sigma-1 Gaussian the kernel and its plain version share."""
    return tuple(image_ops.gaussian_kernel1d(1.0, 2).tolist())


def _enhance_planes(planes: torch.Tensor, means: torch.Tensor,
                    contrast: float, sharpness: float) -> torch.Tensor:
    """Plain version of the kernel's arithmetic on (B, C, H, W) planes with
    one mean per image: contrast, separable blur (rows first) with edge
    replication, unsharp blend. Returns the [0, 1] image before
    normalisation."""
    m = means.view(-1, 1, 1, 1)
    c = torch.clamp(m + (planes - m) * contrast, 0.0, 1.0)
    blur = image_ops.blur_planes(c)
    return torch.clamp(blur + (c - blur) * sharpness, 0.0, 1.0)


def _norm(dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(NORM_MEAN, dtype=dtype, device=device),
            torch.tensor(NORM_STD, dtype=dtype, device=device))


def fused_enhance_plain(images: torch.Tensor, contrast: float = CONTRAST,
                        sharpness: float = SHARPNESS) -> torch.Tensor:
    """Plain PyTorch version of ``fused_enhance``."""
    luma = 0.299 * images[..., 0] + 0.587 * images[..., 1] + 0.114 * images[..., 2]
    means = luma.mean(dim=(1, 2))
    s = _enhance_planes(images.permute(0, 3, 1, 2), means, contrast, sharpness)
    nm, ns = _norm(images.dtype, images.device)
    return ((s.permute(0, 2, 3, 1) - nm) / ns).contiguous()


def enhance_gray_plain(gray: torch.Tensor, contrast: float = CONTRAST,
                       sharpness: float = SHARPNESS) -> torch.Tensor:
    """Plain PyTorch version of ``enhance_gray``."""
    s = _enhance_planes(gray[:, None], gray.mean(dim=(1, 2)), contrast, sharpness)
    nm, ns = _norm(gray.dtype, gray.device)
    return (s - nm.view(1, 3, 1, 1)) / ns.view(1, 3, 1, 1)


def _launch(inp: torch.Tensor, out: torch.Tensor, means: torch.Tensor,
            in_strides: tuple[int, int, int, int], in_channels: int,
            out_strides: tuple[int, int, int, int], contrast: float,
            sharpness: float) -> None:
    lib = _build.library()
    b, h, w = means.shape[0], inp.shape[1], inp.shape[2]
    arr5, arr3 = ctypes.c_float * 5, ctypes.c_float * 3
    g, nm, ns = arr5(*gauss5()), arr3(*NORM_MEAN), arr3(*NORM_STD)
    rc = lib.ocr_enhance(
        inp.data_ptr(), out.data_ptr(), means.data_ptr(), b, h, w, in_channels,
        *in_strides, *out_strides, contrast, sharpness,
        ctypes.addressof(g), ctypes.addressof(nm), ctypes.addressof(ns),
        torch.cuda.current_stream(inp.device).cuda_stream,
    )
    _build.check(rc, "enhance")
    LAUNCHES.add()


def _check_cuda_f32(x: torch.Tensor, ndim: int, name: str) -> None:
    if x.dtype != torch.float32 or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous float32 tensor of {ndim} dims, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )


def fused_enhance(images: torch.Tensor, contrast: float = CONTRAST,
                  sharpness: float = SHARPNESS) -> torch.Tensor:
    """images: (B, H, W, 3) float32 in [0, 1] -> normalised (B, H, W, 3):
    the JAX ``fused_enhance`` signature. Luma mean per image, contrast blend,
    unsharp mask, ImageNet normalisation."""
    if images.device.type == "cpu":
        return fused_enhance_plain(images, contrast, sharpness)
    _check_cuda_f32(images, 4, "fused_enhance")
    if images.shape[-1] != 3:
        raise ValueError(f"fused_enhance: expected 3 channels, got {images.shape}")
    luma = 0.299 * images[..., 0] + 0.587 * images[..., 1] + 0.114 * images[..., 2]
    means = luma.mean(dim=(1, 2)).contiguous()
    out = torch.empty_like(images)
    b, h, w, _ = images.shape
    nhwc = (h * w * 3, 1, w * 3, 3)  # strides of (b, c, y, x)
    _launch(images, out, means, nhwc, 3, nhwc, contrast, sharpness)
    return out


def enhance_gray(gray: torch.Tensor, contrast: float = CONTRAST,
                 sharpness: float = SHARPNESS) -> torch.Tensor:
    """The detector's entry: (B, H, W) float32 gray pages in [0, 1] ->
    (B, 3, H, W) normalised model input (the three channels differ only in
    their normalisation). Equal to ``fused_enhance`` of the gray page
    repeated three times, up to the luma weights' rounding."""
    if gray.device.type == "cpu":
        return enhance_gray_plain(gray, contrast, sharpness)
    _check_cuda_f32(gray, 3, "enhance_gray")
    means = gray.mean(dim=(1, 2)).contiguous()
    b, h, w = gray.shape
    out = torch.empty((b, 3, h, w), dtype=torch.float32, device=gray.device)
    _launch(gray, out, means, (h * w, 0, w, 1), 1, (3 * h * w, h * w, w, 1),
            contrast, sharpness)
    return out
