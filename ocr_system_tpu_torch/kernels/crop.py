"""Batched axis-aligned crop+resize for the recognizer, as one CUDA kernel
(``csrc/kernels.cu`` ``crop_kernel``).

Replaces ocr_system_tpu/kernels/crop_pallas.py::crop_boxes_matmul and keeps
its semantics: source coordinates clamped into the page (border
replication), bilinear, scaled by 1/255, columns >= w_valid zeroed. The TPU
kernel builds hat-weight matmuls on a 128-row slab to avoid TPU gathers;
Hopper gathers well, so the kernel samples 4 taps directly and has no box
height bound. It is bound by its output bytes (crops x H x W), written in
the recognizer's compute dtype (float32 or bfloat16).

On a CPU tensor ``crop_boxes`` runs the plain PyTorch version below; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ocr_system_tpu_torch.kernels import _build

LAUNCHES = _build.LaunchCounter()
MAX_WIDTH = 6000  # the column taps, 8 B each, stay in 48 KB of shared memory


def _axis(lo: torch.Tensor, hi: torch.Tensor, n_out: int, size: int):
    """Clamped source coordinates along one axis: (n, n_out) floor indices
    of both taps and the fractional weight."""
    steps = torch.arange(n_out, dtype=torch.float32, device=lo.device)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which rounds differently from the
    # kernel's (and the reference's) true division
    denom = torch.tensor(float(n_out - 1), device=lo.device)
    s = lo[:, None] + ((hi - lo)[:, None] * steps) / denom
    s = s.clamp(0.0, float(size - 1))
    f = torch.floor(s)
    a = f.long()
    return a, (a + 1).clamp(max=size - 1), s - f


def crop_boxes_plain(pages: torch.Tensor, aabbs: torch.Tensor,
                     w_valid: torch.Tensor, out_shape: tuple[int, int],
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of ``crop_boxes``."""
    _build.check_out_dtype(out_dtype, "crop_boxes")
    p, rows, cols = pages.shape
    n = aabbs.shape[1]
    h_out, w_out = out_shape
    boxes = aabbs.reshape(-1, 4).float()
    page_of = torch.arange(p, device=pages.device).repeat_interleave(n)
    ya, yb, dy = _axis(boxes[:, 1], boxes[:, 3], h_out, rows)
    xa, xb, dx = _axis(boxes[:, 0], boxes[:, 2], w_out, cols)
    flat = pages.reshape(p, -1)

    def tap(y, x):  # (n, h_out, w_out) taps, scaled to [0, 1]
        lin = y[:, :, None] * cols + x[:, None, :]
        v = flat[page_of[:, None, None], lin]
        return v.float() * (1.0 / 255.0)

    dy, dx = dy[:, :, None], dx[:, None, :]
    left = (1.0 - dy) * tap(ya, xa) + dy * tap(yb, xa)
    right = (1.0 - dy) * tap(ya, xb) + dy * tap(yb, xb)
    out = (1.0 - dx) * left + dx * right
    cols_idx = torch.arange(w_out, device=pages.device)
    keep = cols_idx[None, :] < w_valid.reshape(-1, 1)
    return torch.where(keep[:, None, :], out, torch.zeros_like(out)).to(out_dtype)


def crop_boxes(pages: torch.Tensor, aabbs: torch.Tensor, w_valid: torch.Tensor,
               out_shape: tuple[int, int],
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """pages (P, R, C) uint8 gray; aabbs (P, N, 4) [x0, y0, x1, y1] float32
    in page coords; w_valid (P, N) int32 -> (P*N, h, w) crops in [0, 1] in
    ``out_dtype``, columns >= w_valid zeroed. Height and width are at
    least 2, as for the JAX kernel."""
    if pages.device.type == "cpu":
        return crop_boxes_plain(pages, aabbs, w_valid, out_shape, out_dtype)
    _build.check_out_dtype(out_dtype, "crop_boxes")
    p, rows, cols = pages.shape
    h_out, w_out = out_shape
    n = aabbs.shape[1] if aabbs.dim() == 3 else -1
    for name, t, dtype, shape in (("pages", pages, torch.uint8, (p, rows, cols)),
                                  ("aabbs", aabbs, torch.float32, (p, n, 4)),
                                  ("w_valid", w_valid, torch.int32, (p, n))):
        if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"crop_boxes: {name} must be a contiguous {dtype} tensor of "
                f"shape {shape}, got {t.dtype} {tuple(t.shape)}"
            )
    if not (aabbs.device == w_valid.device == pages.device):
        raise ValueError("crop_boxes: all inputs must be on one device")
    if h_out < 2 or w_out < 2:
        raise ValueError(f"crop_boxes: output shape {out_shape}: both sides must be "
                         "at least 2")
    if w_out > MAX_WIDTH:
        raise ValueError(f"crop_boxes: width {w_out} above the kernel's {MAX_WIDTH}")
    out = torch.empty((p * n, h_out, w_out), dtype=out_dtype, device=pages.device)
    if p * n == 0:
        return out
    rc = _build.library().ocr_crop(
        pages.data_ptr(), aabbs.data_ptr(), w_valid.data_ptr(), out.data_ptr(),
        int(out_dtype == torch.bfloat16), p * n, n, rows, cols, h_out, w_out,
        torch.cuda.current_stream(pages.device).cuda_stream,
    )
    _build.check(rc, "crop")
    LAUNCHES.add()
    return out
