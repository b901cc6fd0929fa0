"""DBNet text detection model, inference only (port of
ocr_system_tpu/models/dbnet.py): backbone -> FPN -> prob head -> sigmoid.
The threshold head exists only for training and is not ported."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ocr_system_tpu_torch.core.dtypes import DTypePolicy, default_policy
from ocr_system_tpu_torch.models.backbone import Backbone, ConvBNAct, FPNNeck
from ocr_system_tpu_torch.models.layers import BatchNorm, ConvTranspose2x2


class _Head(nn.Module):
    """Prob head: conv -> 2x deconv to full resolution -> sigmoid."""

    def __init__(self, features: int):
        super().__init__()
        f = features // 4
        self.conv = ConvBNAct(features, f, 3)
        self.up1 = ConvTranspose2x2(f, f)
        self.bn = BatchNorm(f)
        self.up2 = ConvTranspose2x2(f, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn(self.up1(self.conv(x))))
        return torch.sigmoid(self.up2(x).float())[:, 0]  # (B, H, W)


class DBNet(nn.Module):
    """Input: (B, H, W, 3) normalized images, H and W multiples of 32, as in
    the JAX model. Output: the (B, H, W) float32 probability map."""

    def __init__(self, neck_features: int = 96,
                 policy: DTypePolicy = default_policy()):
        super().__init__()
        self.policy = policy
        self.backbone = Backbone()
        self.neck = FPNNeck(self.backbone.stage_features, neck_features)
        self.prob_head = _Head(neck_features)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        return self.forward_nchw(x_nhwc.permute(0, 3, 1, 2))

    def forward_nchw(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) input: the layout the enhance kernel writes."""
        feats = self.backbone(self.policy.cast_compute(x))
        return self.prob_head(self.neck(feats))
