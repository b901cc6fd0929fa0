"""Faults planted underneath the timed path, each of which the check must
catch: an answer altered where it is produced, and half of the batch left
out. Each takes ``setattr`` (``pytest``'s ``monkeypatch.setattr`` in the
tests, the builtin in ``tools/calibrate.py``, which reads them on the card)
and patches the program's classes or modules before an engine is built.
"""

from __future__ import annotations


def text_altered(setattr):
    """Every decoded text with its last character changed."""
    from ocr_system_tpu_torch.ops import ctc

    real = ctc.ids_to_text

    def altered(ids, charset):
        return [(t[:-1] + ("y" if t.endswith("x") else "x")) if t else "x"
                for t in real(ids, charset)]

    setattr(ctc, "ids_to_text", altered)


def decodes_dropped(setattr):
    """Every other crop's decode left empty."""
    from ocr_system_tpu_torch.ops import ctc

    real = ctc.ctc_greedy_decode

    def half(logits, lengths=None, *a, **kw):
        ids, conf, n = real(logits, lengths, *a, **kw)
        ids = ids.clone()
        ids[1::2] = ctc.PAD_ID
        return ids, conf, n

    setattr(ctc, "ctc_greedy_decode", half)


def boxes_dropped(setattr):
    """Every other box of each page left out after detection (with its
    routing, where routing is per box)."""
    from ocr_system_tpu_torch.engine.pipeline import TorchOCREngine

    real = TorchOCREngine.det_stage

    def dropped(self, pages):
        dets = real(self, pages)
        for d in dets:
            d.boxes = d.boxes[::2]
            if isinstance(d.routing, list):
                d.routing = d.routing[::2]
        return dets

    setattr(TorchOCREngine, "det_stage", dropped)


def pages_emptied(setattr):
    """Every even-numbered page served as a success with no words."""
    from ocr_system_tpu_torch.engine.pipeline import TorchOCREngine

    real = TorchOCREngine._finish_page

    def emptied(self, page, det, recs, t0):
        out = real(self, page, det, recs, t0)
        if page.page_number % 2 == 0:
            out.layout_boxes, out.markdown, out.html = [], "", ""
            out.json_content = {"lines": []}
        return out

    setattr(TorchOCREngine, "_finish_page", emptied)


def map_mirrored(setattr):
    """The detector's probability map mirrored left to right."""
    from ocr_system_tpu_torch.models.dbnet import DBNet

    real = DBNet.forward_nchw
    setattr(DBNet, "forward_nchw", lambda self, x, *a, **kw: real(self, x, *a, **kw).flip(-1))


def canvas_altered(setattr):
    """The detector's canvas (its wire unpacked) off by one in every pixel."""
    from ocr_system_tpu_torch.engine import detector

    real = detector.unpack_wire
    setattr(detector, "unpack_wire", lambda x, bits: real(x, bits) ^ 1)


def tags_altered(setattr):
    """The layout model's tag logits rolled by one tag."""
    from ocr_system_tpu_torch.models.layout_extractor import LayoutExtractor

    real = LayoutExtractor.forward

    def rolled(self, *a, **kw):
        out = real(self, *a, **kw)
        return {**out, "tag_logits": out["tag_logits"].roll(1, dims=-1)}

    setattr(LayoutExtractor, "forward", rolled)


FAULTS = {f.__name__: f for f in (text_altered, decodes_dropped, boxes_dropped, pages_emptied,
                                  map_mirrored, canvas_altered, tags_altered)}
