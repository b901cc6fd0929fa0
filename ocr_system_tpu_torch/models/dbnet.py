"""DBNet text detection model (port of ocr_system_tpu/models/dbnet.py):
backbone -> FPN -> prob head -> sigmoid, plus, for training, the threshold
head, the binary map ``sigmoid(K * (prob - thresh))`` and ``db_loss``.

Serving builds the model without the threshold head (``weights/det.npz``
has none); a trainer builds it with ``thresh_head=True``. A trained state
dict carries the threshold head, and a serving model drops it on load
(``TRAIN_ONLY``), as the JAX package's loader ignores it."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ocr_system_tpu_torch.core.dtypes import DTypePolicy, default_policy, widen
from ocr_system_tpu_torch.models.backbone import Backbone, ConvBNAct, FPNNeck
from ocr_system_tpu_torch.models.layers import BatchNorm, ConvTranspose2x2, init_flax_

K = 50.0  # the binarization's steepness, binary = sigmoid(K (prob - thresh))


class _Head(nn.Module):
    """Prob/thresh head: conv -> 2x deconv to full resolution -> sigmoid."""

    def __init__(self, features: int):
        super().__init__()
        f = features // 4
        self.conv = ConvBNAct(features, f, 3)
        self.up1 = ConvTranspose2x2(f, f)
        self.bn = BatchNorm(f)
        self.up2 = ConvTranspose2x2(f, 1)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(self.bn(self.up1(self.conv(x, train)), train))
        return torch.sigmoid(widen(self.up2(x)))[:, 0]  # (B, H, W)


class DBNet(nn.Module):
    """Input: (B, H, W, 3) normalized images, H and W multiples of 32, as in
    the JAX model. Output: the (B, H, W) float32 probability map; with
    ``train=True``, a dict of the float32 ``prob``, ``thresh`` and
    ``binary`` maps, the BatchNorms on their batch statistics."""

    TRAIN_ONLY = ("thresh_head.",)  # state-dict prefixes a serving model drops

    def __init__(self, neck_features: int = 96,
                 policy: DTypePolicy = default_policy(), thresh_head: bool = False):
        super().__init__()
        self.policy = policy
        self.backbone = Backbone()
        self.neck = FPNNeck(self.backbone.stage_features, neck_features)
        self.prob_head = _Head(neck_features)
        self.thresh_head = _Head(neck_features) if thresh_head else None

    def forward(self, x_nhwc: torch.Tensor, train: bool = False):
        return self.forward_nchw(x_nhwc.permute(0, 3, 1, 2), train)

    def forward_nchw(self, x: torch.Tensor, train: bool = False):
        """(B, 3, H, W) input: the layout the enhance kernel writes."""
        fused = self.neck(self.backbone(self.policy.cast_compute(x), train), train)
        prob = self.prob_head(fused, train)
        if not train:
            return prob
        if self.thresh_head is None:
            raise ValueError("training DBNet needs its threshold head: DBNet(thresh_head=True)")
        thresh = self.thresh_head(fused, train)
        return {"prob": prob, "thresh": thresh,
                "binary": torch.sigmoid(K * (prob - thresh))}

    def init_flax_(self, generator: torch.Generator) -> "DBNet":
        return init_flax_(self, generator)


def db_loss(outputs: dict, gt_shrink: torch.Tensor, gt_shrink_mask: torch.Tensor,
            gt_thresh: torch.Tensor, gt_thresh_mask: torch.Tensor) -> torch.Tensor:
    """DB training loss: BCE(prob) + L1(thresh) + dice(binary), weights
    1/10/5 per the paper, eps 1e-6. All inputs (B, H, W) float32."""
    return db_loss_finish(db_loss_terms(outputs, gt_shrink, gt_shrink_mask, gt_thresh,
                                        gt_thresh_mask))


def db_loss_terms(outputs: dict, gt_shrink: torch.Tensor, gt_shrink_mask: torch.Tensor,
                  gt_thresh: torch.Tensor, gt_thresh_mask: torch.Tensor) -> dict:
    """The sums ``db_loss`` divides: summed over the shards of a dp batch,
    they give the global batch's loss (``db_loss_finish``)."""
    eps = 1e-6
    prob, thresh, binary = outputs["prob"], outputs["thresh"], outputs["binary"]
    # balanced BCE on the shrink map (the reference masks and normalises
    # instead of mining negatives 3:1)
    bce = -(gt_shrink * torch.log(prob + eps)
            + (1 - gt_shrink) * torch.log(1 - prob + eps))
    return {
        "bce": (bce * gt_shrink_mask).sum(), "shrink_mask": gt_shrink_mask.sum(),
        "l1": ((thresh - gt_thresh).abs() * gt_thresh_mask).sum(),
        "thresh_mask": gt_thresh_mask.sum(),
        "inter": (binary * gt_shrink * gt_shrink_mask).sum(),
        "union": (binary * gt_shrink_mask).sum() + (gt_shrink * gt_shrink_mask).sum(),
    }


def db_loss_finish(t: dict) -> torch.Tensor:
    eps = 1e-6
    bce = t["bce"] / (t["shrink_mask"] + eps)
    l1 = t["l1"] / (t["thresh_mask"] + eps)
    dice = 1.0 - 2.0 * t["inter"] / (t["union"] + eps)
    return bce + 10.0 * l1 + 5.0 * dice
