"""The reference of the example comparison ``layout_tag_gap``: by how
much a tag lies below the plain float32 layout model's best, per token. It
imports nothing of the program."""

from __future__ import annotations

import torch

from portbench.reference import models as M


def tag_gaps(sd, ids, boxes, mask, tags) -> torch.Tensor:
    """(1, L) ids, (1, L, 4) boxes, (1, L) mask and (L,) tags -> per valid
    token (the mask's leading run), the reference's best log-probability
    less that of the tag."""
    n = int(mask.sum())
    ref = torch.log_softmax(M.layout_tag_logits(sd, ids, boxes, mask), -1)[0, :n]
    return ref.max(-1).values - ref.gather(-1, tags[:n, None])[:, 0]


def control_tags(sd, ids, boxes, mask, prec: M.Precision) -> torch.Tensor:
    """The tags the reference puts first when it computes in ``prec``."""
    return M.layout_tag_logits(prec.cast(sd), ids, boxes, mask, prec)[0].float().argmax(-1)
