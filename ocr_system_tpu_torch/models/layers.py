"""Layers with the flax semantics the JAX models were trained under.

Parameters are stored in float32 (the policy's ``param_dtype``) and cast to
the activation's dtype at use, which is what a flax module with
``dtype=compute, param_dtype=float32`` does. Layout is NCHW inside the port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ocr_system_tpu_torch.core.dtypes import widen
from ocr_system_tpu_torch.core.mesh import DATA_AXIS, axis_index, axis_psum, axis_size


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
    """BatchNorm with flax's arithmetic (``nn.BatchNorm``, momentum 0.99,
    epsilon 1e-5). ``(x - mean) * (scale * rsqrt(var + eps)) + bias`` in
    float32 (the float32 statistics promote it), rounded once to x's dtype.
    Inference reads the running statistics; ``train=True`` normalises with
    the batch's own float32 statistics over every axis but the channel, the
    variance as E[x^2] - E[x]^2 clipped at 0 (flax's ``use_fast_variance``),
    and moves the running ones to ``momentum * running + (1 - momentum) *
    batch`` with that biased variance (``nn.BatchNorm2d`` would use momentum
    the other way round and the unbiased variance). Under a dp-sharded step
    (``core.mesh.run_sharded`` over dp) the batch statistics are the global
    batch's, as flax's BatchNorm computes them under ``jit`` over a
    dp-sharded batch: each shard's sum and sum of squares are summed over
    the shards (``axis_psum``), and the first shard moves the running
    statistics. Names follow ``nn.BatchNorm2d``."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.99):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xf = widen(x)
        if train:
            dims = [0, *range(2, x.dim())]
            if axis_size(DATA_AXIS) == 1:
                mean, sq = xf.mean(dims), xf.square().mean(dims)
            else:
                count = axis_psum(torch.tensor(float(x.numel() // x.shape[1])), DATA_AXIS)
                sums = axis_psum(torch.stack([xf.sum(dims), xf.square().sum(dims)]), DATA_AXIS)
                mean, sq = sums / count.to(sums)
            var = (sq - mean.square()).clamp_min(0.0)
            if axis_index(DATA_AXIS) == 0:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(x.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in the activation's dtype (flax ``Dense``).
    ``axes``: the logical axes of the flax kernel, ``(in, out)``, for
    ``parallel.sharding`` (None: unannotated, replicated); ``shard_groups``:
    the number of fused outputs (3 for q, k, v) that split over tp each on
    its own, in whole ``shard_unit``s (a head's features)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 axes: tuple[str, str] | None = None, shard_groups: int = 1,
                 shard_unit: int = 1):
        super().__init__(in_features, out_features, bias)
        self.axes = axes
        self.shard_groups = shard_groups
        self.shard_unit = shard_unit

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """flax ``LayerNorm``: eps 1e-6, statistics in float32, output in x's
    dtype."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(
            widen(x), self.normalized_shape, self.weight, self.bias, self.eps
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


# flax's lecun_normal draws a normal truncated at two standard deviations and
# divides the scale by this factor, the standard deviation of that truncated
# unit normal, so the draw's variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _fan_in(m: nn.Module) -> int:
    w = m.weight
    # ConvTranspose2d stores (in, out, kh, kw): fan_in is dim 0
    if isinstance(m, nn.ConvTranspose2d):
        return w.shape[0] * w[0, 0].numel()
    return w[0].numel()


def truncated_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    """flax ``truncated_normal``: a unit normal truncated to [-2, 2], times
    ``std``."""
    with torch.no_grad():
        d = torch.empty(t.shape)
        nn.init.trunc_normal_(d, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return t.copy_(d * std)


def init_flax_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded from-scratch init with flax's default initializers, the ones a
    flax ``model.init`` gives these modules: ``lecun_normal`` conv and
    Dense kernels (truncated normal, variance 1 / fan_in), zero biases,
    BatchNorm at identity with zero mean and unit variance statistics, unit
    LayerNorm. Models with parameters of their own (position tables,
    embeddings) finish in their ``init_flax_``. Draws on the CPU from
    ``generator``, so a seed gives the same weights on every device."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                truncated_normal_(m.weight, 1.0 / (_fan_in(m) ** 0.5 * _TRUNC_STD), generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (BatchNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, BatchNorm):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
    return module
