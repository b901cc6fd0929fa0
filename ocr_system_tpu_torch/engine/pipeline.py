"""The OCR engine: page pixels -> markdown + layout boxes (port of
ocr_system_tpu/engine/pipeline.py).

Same service contract as the JAX package: ``OCROutput`` /
``DocumentOCRResult``, and layout boxes in Azure's shape
``{"type", "content", "confidence", "polygon", "page_number"}``.

The port runs every OCR serving default: the neural, classical and hybrid
detectors (``get_engine``), script routing between the Latin and the
Devanagari recognizer (``rec_charset="auto"``) with both rescue passes,
glue split, selection marks, handwriting, tables and reading order. The
detector refuses the options it does not run yet (``engine/detector.py``).
``TorchOCREngine.process_document`` decodes an image or a PDF's pages;
``warmup`` and ``get_status`` serve the HTTP application, and
``FakeOCREngine`` (``ocr_engine="fake"``) its tests.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.engine import glue_split, reading_order
from ocr_system_tpu_torch.engine import script as script_mod
from ocr_system_tpu_torch.engine.detector import Detector
from ocr_system_tpu_torch.engine.handwriting import detect_handwriting
from ocr_system_tpu_torch.engine.host_image import rgb_to_gray
from ocr_system_tpu_torch.engine.preprocess import PageImage, load_document
from ocr_system_tpu_torch.engine.recognizer import Recognizer
from ocr_system_tpu_torch.engine.selection_marks import (
    detect_selection_marks,
    filter_marks_against_words,
    page_components,
)
from ocr_system_tpu_torch.extract.postfix import _cer, clean_key
from ocr_system_tpu_torch.extract.tables import find_tables
from ocr_system_tpu_torch.models.charsets import get_charset
from ocr_system_tpu_torch.ops.boxes import DetectedBox
from ocr_system_tpu_torch.utils.profiler import count, span, timed

_EMPTY_QUADS = np.zeros((0, 4, 2), np.float32)


@dataclass
class OCROutput:
    """Per-page OCR result."""

    success: bool
    markdown: str = ""
    html: str = ""
    json_content: dict = field(default_factory=dict)
    layout_boxes: list[dict] = field(default_factory=list)
    page_number: int = 1
    page_width: float = 0.0
    page_height: float = 0.0
    processing_time_ms: float = 0.0
    error: str | None = None
    processed_image: np.ndarray | None = None  # (H, W, 3) uint8 for overlay UI


@dataclass
class DocumentOCRResult:
    """Whole-document result."""

    success: bool
    pages: list[OCROutput] = field(default_factory=list)
    combined_markdown: str = ""
    combined_html: str = ""
    total_pages: int = 0
    processing_time_ms: float = 0.0
    error: str | None = None
    stage_times_ms: dict = field(default_factory=dict)

    @property
    def combined_layout_boxes(self) -> list[dict]:
        return [b for p in self.pages for b in p.layout_boxes]


class TorchOCREngine:
    """The det+rec engine on the card (the JAX package's ``JaxOCREngine``);
    ``get_engine`` picks its detector."""

    name = "torch"

    # pages letterbox to detection canvases at scale s <= 1; recognition
    # crops from those canvases only above this scale (below it the canvas
    # has less resolution than the page)
    REC_CANVAS_MIN_SCALE = 0.98

    def __init__(self, settings: Settings | None = None,
                 detector=None,
                 recognizer: Recognizer | None = None,
                 device: str | torch.device | None = None):
        self.settings = settings or get_settings()
        self.detector = detector or Detector(self.settings, device=device)
        self.recognizer = recognizer or Recognizer(self.settings, device=device)
        # script routing's second recognizer, built once here (det_stage
        # runs in the scheduler's worker thread, the rescues in the caller's)
        self.devanagari = self._devanagari_recognizer()
        # wall ms of the last det_stage ("det", "route", and "det_neural" /
        # "det_classical" under the hybrid detector) and rec_stage ("rec",
        # "rescue", "glue", "finish") calls
        self.stage_ms: dict[str, float] = {}
        # per page of the last rec_stage call: each det box's recognizer
        # (charset name) by its flat polygon (``box_recognizers``), and the
        # crops each rescue re-decoded and replaced
        self.routed: list[dict[tuple, str]] = []
        self.rescued: list[dict[str, list[int]]] = []

    # -- script routing --

    def _devanagari_recognizer(self) -> Recognizer | None:
        """Under ``rec_charset="auto"``: the Devanagari recognizer on
        ``rec_checkpoint_devanagari``, else on
        ``<checkpoint_dir>/rec_devanagari.npz`` where that file exists, else
        None (no routing and no rescue). The other charsets route without
        it. It runs on the primary recognizer's device."""
        s = self.settings
        if s.rec_charset != "auto":
            return None
        ckpt = s.rec_checkpoint_devanagari
        if not ckpt:
            default = os.path.join(s.checkpoint_dir, "rec_devanagari.npz")
            ckpt = default if os.path.isfile(default) else ""
        if not ckpt:
            return None
        return Recognizer(s.model_copy(update={"rec_checkpoint": ckpt}),
                          charset=get_charset("devanagari"), device=self.recognizer.device)

    def _route_and_normalize(self, dets) -> list:
        """Per page, the recognizer choice and the Devanagari box
        re-segmentation. Routing runs under ``rec_charset`` "auto" (with the
        Devanagari recognizer) and "devanagari"; otherwise every page uses
        the primary recognizer.

        Returns, per page, one Recognizer (every box) or a list aligned
        with the page's boxes: Hindi forms are script-mixed at the box
        level (Devanagari keys, ASCII values), and the Devanagari charset
        cannot represent ASCII letters, so ASCII crops on a Hindi page go
        back to the primary Latin recognizer."""
        s = self.settings

        def host_view(d):
            # the host passes read only the luma (2-D passes through)
            return d.gray if d.gray is not None else d.page

        def split_cols(d):
            if s.det_split_column_gaps:
                d.boxes = script_mod.split_column_merged(host_view(d), d.boxes)

        deva = self.recognizer if s.rec_charset == "devanagari" else self.devanagari
        if s.rec_charset not in ("auto", "devanagari") or deva is None:
            for d in dets:
                split_cols(d)
            return [self.recognizer] * len(dets)

        def route_one(d):
            pixels = host_view(d)
            quads = np.array([b.quad for b in d.boxes], np.float32).reshape(-1, 4, 2)
            if s.rec_charset == "devanagari":
                sc = "devanagari"
            else:
                sc = script_mod.page_script(pixels, quads)
            if sc == "devanagari":
                d.boxes = script_mod.resegment_devanagari(
                    pixels, d.boxes, pad_ratio=s.deva_reseg_pad_ratio,
                    latin_pad_ratio=s.det_box_pad_ratio,
                )
                if deva is not self.recognizer and s.deva_percrop_routing:
                    gray = script_mod._to_gray(pixels)
                    return [
                        deva if script_mod.crop_script(
                            script_mod._crop_aabb(gray, b.quad)) == "devanagari"
                        else self.recognizer
                        for b in d.boxes
                    ]
                return deva
            split_cols(d)
            return self.recognizer

        if len(dets) <= 1:
            return [route_one(d) for d in dets]
        # host work per page (ink components), numpy and the native ops,
        # which release the GIL; each page touches only its own DetResult
        with ThreadPoolExecutor(max_workers=min(8, len(dets))) as ex:
            return list(ex.map(route_one, dets))

    def process_page(self, page: PageImage) -> OCROutput:
        return self.process_pages([page])[0]

    def process_pages(self, pages: list[PageImage]) -> list[OCROutput]:
        """Detection on the whole page batch at once, recognition of every
        page's crops together."""
        t0 = time.perf_counter()
        dets = self.det_stage(pages)
        return self.rec_stage(pages, dets, t0)

    # split stages so the scheduler can pipeline waves: det of wave N+1
    # runs in a worker thread while rec of wave N runs
    def det_stage(self, pages: list[PageImage]):
        with span("det_stage"):
            count("pages", len(pages))
            with timed("det") as det:
                dets = self.detector.detect_batch([p.pixels for p in pages])
            # routing and re-segmentation run here, so that under the
            # scheduler the det worker pays for them while rec of the last
            # wave runs
            with timed("route") as route:
                for d, r in zip(dets, self._route_and_normalize(dets)):
                    d.routing = r
        self.stage_ms["det"] = det.ms
        self.stage_ms["route"] = route.ms
        self.stage_ms.update(getattr(self.detector, "stage_ms", {}))
        return dets

    def rec_stage(self, pages: list[PageImage], dets, t0: float | None = None) -> list[OCROutput]:
        t0 = time.perf_counter() if t0 is None else t0
        with span("rec_stage"):
            count("pages", len(pages))
            with timed("rec") as rec:
                if any(d.routing is None for d in dets):
                    for d, r in zip(dets, self._route_and_normalize(dets)):
                        d.routing = r
                recognizers = [d.routing for d in dets]
                quads_list = [
                    np.array([b.quad for b in d.boxes], np.float32).reshape(-1, 4, 2)
                    for d in dets
                ]
                if self.settings.rec_tighten_y:
                    quads_list = [
                        script_mod.tighten_y(d.gray if d.gray is not None else d.page, q)
                        for d, q in zip(dets, quads_list)
                    ]
                recs_list, self.rescued = self._recognize(dets, quads_list, recognizers)
            # the rescue's span is the rec span's one child: "rec" is its
            # self time
            self.stage_ms["rec"] = rec.ms - self.stage_ms["rescue"]
            with timed("glue") as glue:
                if self.settings.det_glue_split:
                    self._split_glued(dets, recs_list, recognizers)
                self.routed = [box_recognizers(d) for d in dets]
            self.stage_ms["glue"] = glue.ms
            with timed("finish") as finish:
                if len(pages) <= 1:
                    out = [
                        self._finish_page(p, d, r, t0)
                        for p, d, r in zip(pages, dets, recs_list)
                    ]
                else:
                    # page finishing is host work; finish pages in parallel
                    # as the reference does
                    with ThreadPoolExecutor(max_workers=min(8, len(pages))) as ex:
                        out = list(ex.map(
                            lambda pdr: self._finish_page(*pdr, t0),
                            zip(pages, dets, recs_list),
                        ))
            self.stage_ms["finish"] = finish.ms
        return out

    def _recognize(self, dets, quads_list, recognizers):
        """Recognition grouped by recognizer: one dispatch per recognizer
        the wave uses, per page (a Recognizer entry) or per box (a list
        aligned with the page's boxes); then the rescue pass that applies.
        Returns the results and, per page, the crops each rescue re-decoded
        and replaced."""
        self.stage_ms["rescue"] = 0.0
        rescued = [{"confidence": [0, 0], "digit_glyph": [0, 0]} for _ in dets]
        assign = [
            r if isinstance(r, list) else [r] * len(q)
            for r, q in zip(recognizers, quads_list)
        ]
        recs = {id(r): r for row in assign for r in row}
        if len(recs) <= 1:
            only = next(iter(recs.values())) if recs else self.recognizer
            out = self._recognize_with(only, dets, quads_list)
            if only is self.recognizer:
                self._timed_rescue(self._digit_glyph_rescue, "digit_glyph", rescued,
                                   dets, quads_list, out)
            return out, rescued
        out: list[list] = [[None] * len(q) for q in quads_list]
        for rid, rec in recs.items():
            sel_list = [[j for j, r in enumerate(row) if id(r) == rid] for row in assign]
            sub = self._recognize_with(rec, dets, _masked(quads_list, sel_list))
            for i, sel in enumerate(sel_list):
                for k, j in enumerate(sel):
                    out[i][j] = sub[i][k]
        self._timed_rescue(self._confidence_rescue, "confidence", rescued,
                           dets, quads_list, assign, recs, out)
        return out, rescued

    def _timed_rescue(self, rescue, key: str, rescued: list[dict], *args) -> None:
        """Run one rescue pass (a wave runs at most one of the two),
        recording its counts per page, their sums as counters, and its wall
        ms."""
        with timed("rescue") as sp:
            counts = rescue(*args)
            for row, c in zip(rescued, counts):
                row[key] = c
            count("rescue.redecoded", sum(c[0] for c in counts))
            count("rescue.replaced", sum(c[1] for c in counts))
        self.stage_ms["rescue"] = sp.ms

    def _confidence_rescue(self, dets, quads_list, assign, recs, out) -> list[list[int]]:
        """Re-decode low-confidence crops on script-MIXED pages with the
        page's other recognizer, keeping the higher-confidence read.

        The headline router sees geometry, not glyph provenance: a digits-
        only row on a Hindi page has no headline, so it goes to the Latin
        recognizer, but Hindi pages draw digits in the Devanagari face,
        which the Devanagari recognizer reads natively. Only pages that
        already carry both recognizers take part. Returns per page
        [re-decoded, replaced]."""
        counts = [[0, 0] for _ in dets]
        thresh = self.settings.script_rescue_conf
        if thresh <= 0 or len(recs) <= 1:
            return counts
        for rid, rec in recs.items():
            sel_list = []
            for row, res in zip(assign, out):
                present = {id(r) for r in row}
                sel_list.append([
                    j for j, r in enumerate(row)
                    if id(r) != rid and rid in present and res[j].confidence < thresh
                ])
            if not any(sel_list):
                continue
            sub = self._recognize_with(rec, dets, _masked(quads_list, sel_list))
            for i, sel in enumerate(sel_list):
                counts[i][0] += len(sel)
                for k, j in enumerate(sel):
                    if sub[i][k].confidence > out[i][j].confidence:
                        out[i][j] = sub[i][k]
                        counts[i][1] += 1
        return counts

    def _digit_glyph_rescue(self, dets, quads_list, out) -> list[list[int]]:
        """Re-decode low-confidence, digit-like crops on PURE-Latin waves
        with the Devanagari recognizer when script routing is on.

        A Latin form can carry dates and phone numbers drawn in the
        Devanagari font face, whose digit glyphs the Latin model garbles.
        The Devanagari face has no Latin letters, so this family is digits
        and punctuation only: an alternative read is accepted only when its
        confidence is higher and it holds no Devanagari codepoint, which
        makes cross-script injection on Latin pages impossible. Returns per
        page [re-decoded, replaced]."""
        counts = [[0, 0] for _ in dets]
        thresh = self.settings.script_rescue_conf
        deva = self.devanagari
        if thresh <= 0 or self.settings.rec_charset != "auto" or deva is None:
            return counts
        sel_list = [
            [j for j, r in enumerate(row)
             if r.confidence < thresh and _digit_plausible(r.text)]
            for row in out
        ]
        if not any(sel_list):
            return counts
        sub = self._recognize_with(deva, dets, _masked(quads_list, sel_list))
        for i, sel in enumerate(sel_list):
            counts[i][0] = len(sel)
            for k, j in enumerate(sel):
                alt = sub[i][k]
                if (alt.confidence > out[i][j].confidence and alt.text.strip()
                        and not _has_devanagari(alt.text)):
                    out[i][j] = alt
                    counts[i][1] += 1
        return counts

    def _recognize_with(self, recognizer: Recognizer, dets, quads_list):
        """Crop from the det stage's device canvases when they carry full
        page resolution (one page upload per wave, shared by every
        recognizer); host pages otherwise."""
        reusable = all(
            d.canvas_stack is not None
            and d.canvas_scale >= self.REC_CANVAS_MIN_SCALE
            for d in dets
        ) and len({id(d.canvas_stack) for d in dets}) == 1
        if not reusable or not dets:
            return recognizer.recognize_pages([d.page for d in dets], quads_list)
        stack = dets[0].canvas_stack
        row_quads: list[np.ndarray] = [_EMPTY_QUADS] * stack.shape[0]
        for d, q in zip(dets, quads_list):
            row_quads[d.canvas_row] = (q * d.canvas_scale).astype(np.float32)
        row_recs = recognizer.recognize_on_device_stack(stack, row_quads)
        return [row_recs[d.canvas_row] for d in dets]

    def _split_glued(self, dets, recs_list, recognizers) -> None:
        """Lexicon-guided re-segmentation of column-merged det boxes (see
        engine/glue_split.py): the text says '<value><known label>:', the
        pixels show a column gap -> split the quad there and re-recognize
        both halves in one batch (from the host pages, as the reference
        does). A split stays only when its right half still reads as the
        label. Pages routed to the primary recognizer only: the glue family
        is multi-column Latin forms, and Devanagari pages re-segment by
        headline."""
        plans: list[tuple[int, list]] = []
        for i, (d, recs) in enumerate(zip(dets, recs_list)):
            if recognizers[i] is not self.recognizer or not d.boxes:
                continue
            texts = [r.text for r in recs]
            if not any(":" in t for t in texts):
                continue
            gray = d.gray if d.gray is not None else rgb_to_gray(d.page)
            plan = glue_split.plan_splits(gray, d.boxes, texts)
            if plan:
                plans.append((i, plan))
        if not plans:
            return
        rec_pages, rec_quads = [], []
        for i, plan in plans:
            rec_pages.append(dets[i].page)
            rec_quads.append(np.stack(
                [q for _, lq, rq, _lab in plan for q in (lq, rq)]
            ).astype(np.float32))
        half_recs = self.recognizer.recognize_pages(rec_pages, rec_quads)
        for (i, plan), halves in zip(plans, half_recs):
            d, recs = dets[i], recs_list[i]
            for k in range(len(plan) - 1, -1, -1):  # reverse: indices stay valid
                bi, lq, rq, label = plan[k]
                lrec, rrec = halves[2 * k], halves[2 * k + 1]
                if not lrec.text.strip() or not rrec.text.strip():
                    continue
                if _cer(label.lower(), clean_key(rrec.text).lower()) > 0.5:
                    continue  # right half no longer reads as the label
                score = d.boxes[bi].score
                d.boxes[bi: bi + 1] = [
                    DetectedBox(quad=lq, score=score),
                    DetectedBox(quad=rq, score=score),
                ]
                recs[bi: bi + 1] = [lrec, rrec]

    def _finish_page(self, page: PageImage, det, recs, t0: float) -> OCROutput:
        """Word, line, table, selection-mark and handwriting layout boxes,
        reading order, markdown and html."""
        s = self.settings
        # crops and the overlay image come from the DESKEWED page the boxes
        # were found on
        pixels = det.page
        blocks = []
        word_boxes: list[dict] = []
        for b, r in zip(det.boxes, recs):
            conf = float(min(b.score, r.confidence) if r.text else b.score * 0.5)
            blocks.append(reading_order.TextBlock(quad=b.quad, text=r.text, confidence=conf))
            word_boxes.append({
                "type": "word",
                "content": r.text,
                "confidence": round(conf, 4),
                "polygon": b.flat_polygon(),
                "page_number": page.page_number,
            })
        table_boxes = [
            t.to_layout_box() for t in find_tables(word_boxes, page.page_number)
        ]
        mark_boxes: list[dict] = []
        cc = det.cc
        if cc is None and (s.enable_selection_marks or s.enable_handwriting_detection):
            # detectors without a det-stage luma (the classical one) pass
            # the page itself
            cc = page_components(det.gray if det.gray is not None else pixels)
        if s.enable_selection_marks:
            mark_boxes = filter_marks_against_words(
                detect_selection_marks(pixels, page.page_number, cc=cc), word_boxes,
            )
        if s.enable_handwriting_detection:
            hand_boxes = detect_handwriting(pixels, word_boxes, page.page_number, cc=cc)
            mark_boxes += hand_boxes
            if hand_boxes:
                # a det box over a handwriting region decodes to symbol
                # soup: the handwriting box stands for the region, so the
                # word leaves the text (markdown, lines) and the layout
                blocks = [
                    b for b in blocks
                    if not _in_boxes(hand_boxes, float(b.quad[:, 0].mean()),
                                     float(b.quad[:, 1].mean()))
                ]
                word_boxes = [
                    w for w in word_boxes
                    if not _in_boxes(hand_boxes, sum(w["polygon"][0::2]) / 4.0,
                                     sum(w["polygon"][1::2]) / 4.0)
                ]
        lines = reading_order.order_blocks(blocks)
        line_boxes = [
            {
                "type": "line",
                "content": ln.text,
                "confidence": round(ln.confidence, 4),
                "polygon": [float(v) for v in ln.quad.reshape(-1)],
                "page_number": page.page_number,
            }
            for ln in lines
        ]
        return OCROutput(
            success=True,
            markdown=reading_order.to_markdown(lines),
            html="<br>\n".join(ln.text for ln in lines),
            json_content={"lines": [ln.text for ln in lines]},
            layout_boxes=word_boxes + line_boxes + table_boxes + mark_boxes,
            page_number=page.page_number,
            page_width=float(page.width),
            page_height=float(page.height),
            processing_time_ms=(time.perf_counter() - t0) * 1000.0,
            processed_image=pixels,
        )

    def process_document(self, data: bytes, filename: str) -> DocumentOCRResult:
        """Decode (an image, or a PDF's pages), run every page through the
        PageScheduler, combine."""
        t0 = time.perf_counter()
        try:
            pages = load_document(data, filename, dpi=self.settings.pdf_raster_dpi)
        except Exception as e:  # a decode failure is a structured error
            return DocumentOCRResult(success=False, error=f"decode failed: {e}")
        from ocr_system_tpu_torch.engine.scheduler import PageScheduler

        scheduler = PageScheduler(self, self.settings)
        outputs = scheduler.process(pages)
        doc = document_result(outputs)
        doc.processing_time_ms = (time.perf_counter() - t0) * 1000.0
        doc.stage_times_ms = scheduler.timer.as_ms()
        return doc

    def warmup(self, wave: int | None = None) -> dict:
        """Run each det bucket once, and the largest at ``wave`` pages
        (default ``det_batch_size``), one thread per bucket, so that the
        first upload does not pay for the first launches: the CUDA library's
        build (``kernels/_build.py``; the threads share its lock, so it is
        built once) and cuDNN's and cuBLAS's set-up for the serving shapes.
        Each page carries rows of word-like strokes, so that the trained
        detector finds boxes and recognition runs too. Returns {bucket:
        seconds}, or {bucket: "failed: ..."}: a warm-up never raises."""
        wave = wave or max(self.settings.det_batch_size, 1)
        out: dict = {}

        def ink_page(sz: int) -> np.ndarray:
            rng = np.random.default_rng(12345)
            img = np.full((sz, sz, 3), 245, np.uint8)
            for y in range(40, sz - 40, 36):
                x = 30
                while x < sz - 80:
                    for _ in range(int(rng.integers(3, 8))):  # one word
                        w = int(rng.integers(3, 6))
                        img[y: y + 12, x: x + w] = 30
                        x += w + int(rng.integers(2, 4))
                    x += int(rng.integers(10, 22))  # inter-word gap
            return img

        def warm_bucket(sz: int) -> None:
            t0 = time.perf_counter()
            n = wave if sz == max(self.settings.det_image_buckets) else 1
            pages = [PageImage(pixels=ink_page(sz), page_number=i + 1) for i in range(n)]
            try:
                self.process_pages(pages)
                out[sz] = round(time.perf_counter() - t0, 2)
            except Exception as e:  # a warm-up must never take serving down
                out[sz] = f"failed: {e}"

        threads = [threading.Thread(target=warm_bucket, args=(sz,), daemon=True)
                   for sz in self.settings.det_image_buckets]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    def get_status(self) -> dict:
        """The reference's get_status contract: the engine, its devices
        (the CUDA device names where the engine runs on the card) and its
        buckets."""
        dev = self.recognizer.device
        if dev.type == "cuda":
            devices = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
        else:
            devices = [str(dev)]
        return {
            "engine": self.name,
            "available": True,
            "devices": devices,
            "det_buckets": list(self.settings.det_image_buckets),
            "rec_buckets": list(self.settings.rec_width_buckets),
        }


class FakeOCREngine:
    """Deterministic engine for tests: a fixed layout (the words of
    ``text`` in a row, and one line) on every page, so that service and API
    tests need no model."""

    name = "fake"

    def __init__(self, settings: Settings | None = None, text: str | None = None):
        self.settings = settings or get_settings()
        self.text = text if text is not None else self.settings.fake_ocr_text

    def process_document(self, data: bytes, filename: str) -> DocumentOCRResult:
        try:
            pages = load_document(data, filename)
        except Exception as e:
            return DocumentOCRResult(success=False, error=str(e))
        outs = []
        for pg in pages:
            words = self.text.split()
            w = pg.width / max(len(words) * 2, 1)
            boxes = []
            for i, word in enumerate(words):
                x0 = (2 * i) * w
                boxes.append({
                    "type": "word",
                    "content": word,
                    "confidence": 0.99,
                    "polygon": [x0, 10.0, x0 + w, 10.0, x0 + w, 30.0, x0, 30.0],
                    "page_number": pg.page_number,
                })
            boxes.append({
                "type": "line",
                "content": self.text,
                "confidence": 0.99,
                "polygon": [0.0, 10.0, pg.width * 1.0, 10.0, pg.width * 1.0, 30.0, 0.0, 30.0],
                "page_number": pg.page_number,
            })
            outs.append(OCROutput(
                success=True,
                markdown=self.text,
                html=self.text,
                json_content={"lines": [self.text]},
                layout_boxes=boxes,
                page_number=pg.page_number,
                page_width=float(pg.width),
                page_height=float(pg.height),
                processing_time_ms=1.0,
                processed_image=pg.pixels,
            ))
        return DocumentOCRResult(
            success=True,
            pages=outs,
            combined_markdown=combine_markdown([p.markdown for p in outs]),
            combined_html="<br>".join(p.html for p in outs),
            total_pages=len(outs),
            processing_time_ms=1.0,
        )

    def get_status(self) -> dict:
        return {"engine": self.name, "available": True}


def document_result(outputs: list[OCROutput]) -> DocumentOCRResult:
    """Pages' OCROutputs combined into one document, as
    ``process_document`` combines its pages."""
    return DocumentOCRResult(
        success=all(p.success for p in outputs) and bool(outputs),
        pages=list(outputs),
        combined_markdown=combine_markdown([p.markdown for p in outputs]),
        combined_html="\n<hr>\n".join(p.html for p in outputs),
        total_pages=len(outputs),
        error=None if outputs else "no pages decoded",
    )


def _masked(quads_list: list[np.ndarray], sel_list: list[list[int]]) -> list[np.ndarray]:
    """Each page's selected quads (an empty array where none is)."""
    return [q[sel] if sel else _EMPTY_QUADS for q, sel in zip(quads_list, sel_list)]


def _digit_plausible(text: str) -> bool:
    """Could the Devanagari recognizer's digit glyphs rescue this read? Its
    charset has no Latin letters, so a clearly wordy read never takes the
    alternative. Letters that are classic digit confusions (o/0, l/1, s/5,
    b/8, z/2, g/9, q/4, i/1) still count as digit evidence ('2013-02-13'
    misreads as '?o1?-o2-1]'). Without this gate the rescue re-dispatches
    most of a low-confidence page's crops for no possible gain."""
    if not text.strip():
        return True
    core = [c for c in text if c != " "]
    wordy = sum(c.isalpha() and c.lower() not in "oliszbgq" for c in core)
    return wordy <= 0.3 * len(core)


def _has_devanagari(text: str) -> bool:
    return any("ऀ" <= c <= "ॿ" for c in text)


def box_recognizers(det) -> dict[tuple, str]:
    """A routed DetResult's boxes' recognizers (charset names), keyed by the
    box's flat polygon (a word layout box's polygon)."""
    r = det.routing
    rows = r if isinstance(r, list) else [r] * len(det.boxes)
    return {tuple(b.flat_polygon()): rec.charset.name for b, rec in zip(det.boxes, rows)}


def _in_boxes(boxes: list[dict], cx: float, cy: float) -> bool:
    """Is (cx, cy) inside the axis-aligned extent of any layout box?"""
    for hb in boxes:
        hx = hb["polygon"][0::2]
        hy = hb["polygon"][1::2]
        if min(hx) <= cx <= max(hx) and min(hy) <= cy <= max(hy):
            return True
    return False


def combine_markdown(pages_md: list[str]) -> str:
    """'## Page N' separators between pages; a single page passes through."""
    if len(pages_md) <= 1:
        return pages_md[0] if pages_md else ""
    return "\n\n".join(f"## Page {i + 1}\n\n{md}" for i, md in enumerate(pages_md))


_ENGINES: dict[tuple, TorchOCREngine | FakeOCREngine] = {}
_ENGINES_LOCK = threading.Lock()


def get_engine(settings: Settings | None = None,
               device: str | torch.device | None = None) -> TorchOCREngine | FakeOCREngine:
    """Engine selection by ``settings.ocr_engine`` ("jax": neural,
    "classical", "hybrid", "fake": the test engine) and a lazy, thread-safe singleton, as the
    reference's ``get_engine`` (two concurrent first requests build one
    engine). The reference keys its singleton on the engine name alone; the
    port keys it on the whole settings and the device, so that a second
    configuration in one process gets its own engine."""
    s = settings or get_settings()
    key = (s.ocr_engine, str(device), repr(s))
    engine = _ENGINES.get(key)
    if engine is None:
        with _ENGINES_LOCK:
            engine = _ENGINES.get(key)
            if engine is None:
                engine = _ENGINES[key] = _build_engine(s.ocr_engine, s, device)
    return engine


def _build_engine(key: str, s: Settings, device) -> TorchOCREngine | FakeOCREngine:
    if key == "jax":
        return TorchOCREngine(s, device=device)
    if key == "classical":
        # classical CV detection + neural recognition: the no-weights
        # fallback engine
        from ocr_system_tpu_torch.engine.classical_detector import ClassicalDetector

        return TorchOCREngine(s, detector=ClassicalDetector(s), device=device)
    if key == "hybrid":
        # neural ∪ classical detection (engine/hybrid_detector.py)
        from ocr_system_tpu_torch.engine.hybrid_detector import HybridDetector

        return TorchOCREngine(s, detector=HybridDetector(s, device=device), device=device)
    if key == "fake":
        return FakeOCREngine(s)
    raise ValueError(f"unknown or unported OCR engine {key!r}")
