"""An example comparison file: the layout model's served tags against the
plain float32 reference of ``reference/layout_tags.py``, captured where the
program computes them (``LayoutExtractor.forward``), on every run.

The number is the widest gap, in nats, by which a served tag's reference
log-probability lies below the reference's best, over the kept windows.
"""

from __future__ import annotations

import torch

from portbench.reference import layout_tags as ref
from portbench.reference import models as M

CAPTURE = "ocr_system_tpu_torch.models.layout_extractor:LayoutExtractor.forward"
KEEP = 4


def keep(args, kwargs, out):
    """A window's ids, boxes and mask (each with its batch axis of one) and
    the served tag logits."""
    ids, boxes, mask = args[:3]
    return ids, boxes, mask, out["tag_logits"]


def read(kept, ctx, control=None):
    if not kept:
        return None
    M.set_exact_float32()
    sd = M.load_state(ctx.weights["extract_checkpoint"], ctx.device)
    worst = None
    with torch.no_grad():
        for ids, boxes, mask, logits in kept:
            ids, boxes, mask = (t.to(ctx.device, torch.long) for t in (ids, boxes, mask))
            if not int(mask.sum()):
                continue
            tags = (ref.control_tags(sd, ids, boxes, mask, control) if control is not None
                    else logits[0].to(ctx.device).argmax(-1))
            gap = float(ref.tag_gaps(sd, ids, boxes, mask, tags).max())
            worst = gap if worst is None else max(worst, gap)
    return worst


def tags_negated(setattr):
    """The layout model's tag logits negated: every served tag its least
    likely one."""
    from ocr_system_tpu_torch.models.layout_extractor import LayoutExtractor

    real = LayoutExtractor.forward

    def negated(self, *a, **kw):
        out = real(self, *a, **kw)
        return {**out, "tag_logits": -out["tag_logits"]}

    setattr(LayoutExtractor, "forward", negated)


FAULTS = {"tags_negated": tags_negated}
