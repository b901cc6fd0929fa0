"""Convolutional backbone + FPN neck of the detection model (port of
ocr_system_tpu/models/backbone.py).

MobileNetV3-style inverted residuals, squeeze-excite in stages >= 2,
hard-swish activations, and a top-down FPN whose upsampling is
nearest-neighbour repetition (``jnp.repeat`` in the reference). NCHW inside.
``train`` is threaded as in the flax modules: it puts each BatchNorm on its
batch statistics, except an inverted residual's projection, which the
reference calls without it (so it always reads its running statistics).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ocr_system_tpu_torch.models.layers import BatchNorm, Conv2dSame


class ConvBNAct(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int | tuple[int, int] = 1, groups: int = 1,
                 act: bool = True):
        super().__init__()
        self.conv = Conv2dSame(
            cin, cout, kernel, stride=stride, groups=groups, bias=False
        )
        self.bn = BatchNorm(cout)
        self.act = act

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = self.bn(self.conv(x), train)
        return F.hardswish(x) if self.act else x


class SqueezeExcite(nn.Module):
    def __init__(self, features: int, ratio: int = 4):
        super().__init__()
        self.reduce = Conv2dSame(features, features // ratio, 1)
        self.expand = Conv2dSame(features // ratio, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.relu(self.reduce(s)))
        return x * F.hardsigmoid(s)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, features: int, expand: int, stride: int = 1,
                 use_se: bool = False):
        super().__init__()
        self.expand_conv = ConvBNAct(cin, expand, 1)
        self.depthwise = ConvBNAct(expand, expand, 3, stride, groups=expand)
        self.se = SqueezeExcite(expand) if use_se else None
        self.project = ConvBNAct(expand, features, 1, act=False)
        self.residual = stride == 1 and cin == features

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.depthwise(self.expand_conv(x, train), train)
        if self.se is not None:
            h = self.se(h)
        h = self.project(h)  # no train: the reference's quirk, kept
        return h + x if self.residual else h


class Backbone(nn.Module):
    """4-stage backbone producing features at strides 4, 8, 16, 32."""

    def __init__(self, stage_features: Sequence[int] = (16, 24, 56, 120),
                 stage_depths: Sequence[int] = (1, 2, 3, 3)):
        super().__init__()
        self.stem = ConvBNAct(3, 16, 3, stride=2)
        blocks, cin, ends = [], 16, []
        for si, (f, d) in enumerate(zip(stage_features, stage_depths)):
            for bi in range(d):
                blocks.append(InvertedResidual(
                    cin, f, expand=f * 4, stride=2 if bi == 0 else 1,
                    use_se=si >= 2,
                ))
                cin = f
            ends.append(len(blocks) - 1)
        # flat in the reference's creation order: blocks[i] is flax's
        # InvertedResidual_i
        self.blocks = nn.ModuleList(blocks)
        self.stage_ends = ends
        self.stage_features = tuple(stage_features)

    def forward(self, x: torch.Tensor, train: bool = False) -> list[torch.Tensor]:
        x = self.stem(x, train)
        feats = []
        for i, block in enumerate(self.blocks):
            x = block(x, train)
            if i in self.stage_ends:
                feats.append(x)
        return feats  # strides 4, 8, 16, 32


def _repeat2d(x: torch.Tensor, scale: int) -> torch.Tensor:
    return x.repeat_interleave(scale, dim=2).repeat_interleave(scale, dim=3)


class FPNNeck(nn.Module):
    """Top-down FPN fusing the 4 stages to a single stride-4 map (DB neck)."""

    def __init__(self, in_features: Sequence[int], out_features: int = 96):
        super().__init__()
        self.lateral = nn.ModuleList(
            ConvBNAct(c, out_features, 1) for c in in_features
        )
        self.smooth = nn.ModuleList(
            ConvBNAct(out_features, out_features // 4, 3) for _ in in_features
        )

    def forward(self, feats: list[torch.Tensor], train: bool = False) -> torch.Tensor:
        lat = [conv(f, train) for conv, f in zip(self.lateral, feats)]
        for i in range(len(lat) - 2, -1, -1):
            h, w = lat[i].shape[-2:]
            lat[i] = lat[i] + _repeat2d(lat[i + 1], 2)[..., :h, :w]
        h, w = lat[0].shape[-2:]
        outs = []
        for i, (conv, f) in enumerate(zip(self.smooth, lat)):
            f = conv(f, train)
            if i:
                f = _repeat2d(f, 2**i)[..., :h, :w]
            outs.append(f)
        return torch.cat(outs, dim=1)  # (B, out_features, H/4, W/4)
