"""Fused page enhancement: contrast -> 5-tap Gaussian unsharp -> ImageNet
normalisation, as one CUDA kernel (``csrc/kernels.cu`` ``enhance_kernel``).

Replaces ocr_system_tpu/kernels/preprocess_pallas.py::fused_enhance. The
kernel is bound by device-memory bytes (one read per input element, one
write per output element): the detector's form reads the u8 canvas and
writes the model's compute dtype. Its note in the CUDA source says how the
design stages a tile in shared memory and keeps the stencil in registers.
The per-image luma mean is a separate reduction before the launch, as the
TPU kernel leaves it to XLA.

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
    one mean per image: contrast, separable blur with edge replication,
    unsharp blend. Returns the [0, 1] image before normalisation."""
    m = means.view(-1, 1, 1, 1)
    c = torch.clamp(m + (planes - m) * contrast, 0.0, 1.0)
    blur = image_ops.blur_planes(c)
    return torch.clamp(blur + (c - blur) * sharpness, 0.0, 1.0)


def _norm(dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.tensor(NORM_MEAN, dtype=dtype, device=device),
            torch.tensor(NORM_STD, dtype=dtype, device=device))


def to_unit(gray_u8: torch.Tensor) -> torch.Tensor:
    """u8 -> float32 in [0, 1] as the JAX detector's ``gray_u8 / 255.0``
    rounds under ``jax.jit``: XLA turns the division by a constant into a
    multiply by ``float32(1/255)``, which differs from a true division on
    126 of the 256 values. The factor is a float32 tensor so that the CPU
    and CUDA paths both multiply by it."""
    return gray_u8.float() * torch.tensor(1.0 / 255.0, dtype=torch.float32,
                                          device=gray_u8.device)


def luma_means(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) float32 in [0, 1] -> (B,) means of their luma, as
    ``fused_enhance`` computes them. For a gray page pass its three
    channels (``unit[..., None].expand(-1, -1, -1, 3)``): the luma weights'
    rounding is part of the mean the JAX detector gives the kernel."""
    luma = 0.299 * images[..., 0] + 0.587 * images[..., 1] + 0.114 * images[..., 2]
    return luma.mean(dim=(1, 2))


def gray_means(gray_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 canvases -> the (B,) means that ``enhance_gray``
    takes: the luma means of ``to_unit(gray_u8)`` repeated three times."""
    unit = to_unit(gray_u8)[..., None]
    return luma_means(unit.expand(*unit.shape[:-1], 3))


def fused_enhance_plain(images: torch.Tensor, contrast: float = CONTRAST,
                        sharpness: float = SHARPNESS,
                        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of ``fused_enhance``."""
    _build.check_out_dtype(out_dtype, "fused_enhance")
    means = luma_means(images)
    s = _enhance_planes(images.permute(0, 3, 1, 2), means, contrast, sharpness)
    nm, ns = _norm(images.dtype, images.device)
    return ((s.permute(0, 2, 3, 1) - nm) / ns).to(out_dtype).contiguous()


def enhance_gray_plain(gray_u8: torch.Tensor, means: torch.Tensor,
                       out_dtype: torch.dtype = torch.float32,
                       contrast: float = CONTRAST,
                       sharpness: float = SHARPNESS) -> torch.Tensor:
    """Plain PyTorch version of ``enhance_gray``."""
    _build.check_out_dtype(out_dtype, "enhance_gray")
    s = _enhance_planes(to_unit(gray_u8)[:, None], means.float(), contrast, sharpness)
    nm, ns = _norm(torch.float32, gray_u8.device)
    return ((s - nm.view(1, 3, 1, 1)) / ns.view(1, 3, 1, 1)).to(out_dtype)


def _launch(inp: torch.Tensor, out: torch.Tensor, means: torch.Tensor, planes: int,
            contrast: float, sharpness: float) -> None:
    if out.numel() >= 2**31:
        raise ValueError(f"enhance: {tuple(out.shape)} is too large for 32-bit offsets")
    for name, t in (("input", inp), ("output", out)):
        if t.data_ptr() % 16:
            raise ValueError(f"enhance: the {name} must be 16-byte aligned")
    lib = _build.library()
    arr5, arr3 = ctypes.c_float * 5, ctypes.c_float * 3
    g, nm, ns = arr5(*gauss5()), arr3(*NORM_MEAN), arr3(*NORM_STD)
    rc = lib.ocr_enhance(
        inp.data_ptr(), int(inp.dtype == torch.uint8), out.data_ptr(),
        int(out.dtype == torch.bfloat16), means.data_ptr(), planes,
        inp.shape[-2], inp.shape[-1], contrast, sharpness,
        ctypes.addressof(g), ctypes.addressof(nm), ctypes.addressof(ns),
        torch.cuda.current_stream(inp.device).cuda_stream,
    )
    _build.check(rc, "enhance")
    LAUNCHES.add()


def _check_cuda(x: torch.Tensor, dtype: torch.dtype, ndim: int, name: str) -> None:
    if x.dtype != dtype or x.dim() != ndim or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of {ndim} dims, "
            f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}"
        )


def fused_enhance(images: torch.Tensor, contrast: float = CONTRAST,
                  sharpness: float = SHARPNESS,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """images: (B, H, W, 3) float32 in [0, 1] -> normalised (B, H, W, 3) in
    ``out_dtype``: the JAX ``fused_enhance`` signature. Luma mean per image,
    contrast blend, unsharp mask, ImageNet normalisation. The kernel takes
    planes, so this form transposes on the way in and out (it is not on
    the detector's path)."""
    if images.device.type == "cpu":
        return fused_enhance_plain(images, contrast, sharpness, out_dtype)
    _build.check_out_dtype(out_dtype, "fused_enhance")
    _check_cuda(images, torch.float32, 4, "fused_enhance")
    if images.shape[-1] != 3:
        raise ValueError(f"fused_enhance: expected 3 channels, got {images.shape}")
    means = luma_means(images).contiguous()
    planes = images.permute(0, 3, 1, 2).contiguous()
    out = torch.empty(planes.shape, dtype=out_dtype, device=images.device)
    _launch(planes, out, means, planes.shape[0] * 3, contrast, sharpness)
    return out.permute(0, 2, 3, 1).contiguous()


def enhance_gray(gray_u8: torch.Tensor, means: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32,
                 contrast: float = CONTRAST,
                 sharpness: float = SHARPNESS) -> torch.Tensor:
    """The detector's entry: (B, H, W) uint8 gray canvases and their (B,)
    ``gray_means`` -> (B, 3, H, W) normalised model input in ``out_dtype``
    (the three channels differ only in their normalisation). Equal to
    ``fused_enhance`` of ``to_unit`` of the page repeated three times."""
    if gray_u8.device.type == "cpu":
        return enhance_gray_plain(gray_u8, means, out_dtype, contrast, sharpness)
    _build.check_out_dtype(out_dtype, "enhance_gray")
    _check_cuda(gray_u8, torch.uint8, 3, "enhance_gray")
    b, h, w = gray_u8.shape
    _check_cuda(means, torch.float32, 1, "enhance_gray means")
    if means.shape[0] != b or means.device != gray_u8.device:
        raise ValueError(f"enhance_gray: means must be ({b},) on {gray_u8.device}")
    out = torch.empty((b, 3, h, w), dtype=out_dtype, device=gray_u8.device)
    _launch(gray_u8, out, means, b, contrast, sharpness)
    return out
