"""Layers with the flax semantics the JAX models were trained under.

Parameters are stored in float32 (the policy's ``param_dtype``) and cast to
the activation's dtype at use, which is what a flax module with
``dtype=compute, param_dtype=float32`` does. Layout is NCHW inside the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA ``padding="SAME"``: output ceil(n / s); an odd total pad puts
    the extra pixel at the END (stride 2 on an even size pads (0, 1), which
    ``nn.Conv2d(padding=1)`` gets wrong)."""
    total = max((-(-size // stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """``nn.Conv2d`` with flax's SAME padding and a compute-dtype cast."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (pt, pb), (pl, pr) = (
            same_pads(n, k, s)
            for n, k, s in zip(x.shape[-2:], self.kernel_size, self.stride)
        )
        w = self.weight.to(x.dtype)
        b = None if self.bias is None else self.bias.to(x.dtype)
        if pt == pb and pl == pr:
            return F.conv2d(x, w, b, self.stride, (pt, pl), 1, self.groups)
        x = F.pad(x, (pl, pr, pt, pb))
        return F.conv2d(x, w, b, self.stride, 0, 1, self.groups)


class ConvTranspose2x2(nn.ConvTranspose2d):
    """flax ``ConvTranspose(kernel (2, 2), strides (2, 2))``: no overlap, so
    SAME padding is none; flax's kernel is the spatial flip of torch's (the
    weight converter flips it)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=2
        )


class BatchNorm(nn.Module):
    """Inference BatchNorm with flax's arithmetic: ``(x - mean) * (scale *
    rsqrt(var + eps)) + bias`` in float32 (the float32 statistics promote
    it), rounded once to x's dtype. Names follow ``nn.BatchNorm2d``."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in the activation's dtype (flax ``Dense``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: eps 1e-6, statistics in float32, output in x's
    dtype."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        )
        return y.to(x.dtype)


def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init in flax's defaults: LeCun-normal kernels (variance
    1 / fan_in), zero biases, BatchNorm at identity, unit LayerNorm. Draws on
    the CPU from ``generator`` so a seed gives the same weights everywhere."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                w = m.weight
                # ConvTranspose2d stores (in, out, kh, kw): fan_in is dim 0
                fan_in = (
                    w.shape[0] * w[0, 0].numel()
                    if isinstance(m, nn.ConvTranspose2d)
                    else w[0].numel()
                )
                w.copy_(
                    torch.randn(w.shape, generator=generator) / fan_in**0.5
                )
                if m.bias is not None:
                    m.bias.zero_()
    return module
