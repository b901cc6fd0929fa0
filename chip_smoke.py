#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ocr_system_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout and holds each form of each one
(bf16 and float32 out) against its plain PyTorch version, bit for bit, at
the shapes the serving path gives it (8 pages at the 960 bucket, every rec
width), timing it cold (the L2 evicted before the launch; the kernels
line reports this time for the serving bf16 form) and warm. Then it runs
the port with the trained weights (``weights/*.npz``) at full model width:
160 word quads per page (every width bucket, axis-aligned and rotated)
through ``Recognizer.recognize_pages``; 4 committed forms, one turned,
through the neural engine (``ocr_engine="jax"``); the served engine from
``get_engine`` at every serving default (hybrid detection, script routing
between the Latin and the Devanagari recognizer with both rescue passes,
selection marks, handwriting, glue split) on two waves, the 8 committed
Latin forms and the mixed wave of the 4 committed Hindi forms and 4
Latin forms, at float32 and at bf16, each held against the JAX package's
outputs on the same waves (``assets/smoke_forms_expected.json``: boxes,
texts, marks, handwriting, each word's recognizer, each page's rescue
counts); glue split's re-recognition of the committed glued-lines page
at both dtypes, held against the JAX package's glue split of it; the
Latin wave and then the mixed wave through ``PageScheduler.process``; and
times the host image operations on one form. Each kernel wrapper counts
its launches; the counts are zeroed before each path phase and must be
positive after it (on the CPU the wrappers run their plain versions and
count nothing). On the mixed wave the Devanagari recognizer must dispatch
and launch the crop kernel. Field extraction: ``get_extractor`` must serve
the trained 512 x 8 layout transformer (``weights/extract.npz``), whose
fields on the JAX package's OCR words of the 16 committed pages (each a
one-page document) and of the Latin wave as one 8-page document are held
against the JAX package's (``assets/extract_expected.json``): equal at
float32, 95% at bf16, with its forward pass timed at each token window;
then the served engine's Latin wave goes through
``ExtractionOrchestrator.fields_for`` (extract, save and validate stages)
and its fields, field rows and validation report are held against the JAX
orchestrator's at float32 (reported at bf16).

Each phase prints one JSON line; then one line with every kernel's numbers,
then the card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then nonzero and no result line is printed. Without a CUDA device, or
outside a checkout of the repository, it exits 1 at once.

The phase functions take an engine and pages, so the CPU tests can run
them at a tiny size.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "ocr_system_tpu_torch"
SEED = 1234
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def reset_counts() -> None:
    from ocr_system_tpu_torch.kernels import crop, enhance

    enhance.LAUNCHES.reset()
    crop.LAUNCHES.reset()


def counts() -> dict[str, int]:
    from ocr_system_tpu_torch.kernels import crop, enhance

    return {"enhance": enhance.LAUNCHES.value, "crop": crop.LAUNCHES.value}


def check_outputs(outs, pages) -> int:
    """Every page succeeded, has its size, and every layout polygon is 8
    finite numbers on the page. Returns the word-box count."""
    words = 0
    for out, page in zip(outs, pages):
        if not out.success:
            raise AssertionError(f"page {page.page_number} failed: {out.error}")
        if (out.page_width, out.page_height) != (page.width, page.height):
            raise AssertionError(f"page {page.page_number}: wrong page size")
        for box in out.layout_boxes:
            poly = np.asarray(box["polygon"], np.float64)
            if poly.shape != (8,) or not np.isfinite(poly).all():
                raise AssertionError(f"malformed polygon {box['polygon']}")
            if (poly[0::2].min() < -1 or poly[0::2].max() > page.width + 1
                    or poly[1::2].min() < -1 or poly[1::2].max() > page.height + 1):
                raise AssertionError(f"polygon off the page: {box['polygon']}")
        words += sum(b["type"] == "word" for b in out.layout_boxes)
    return words


def served_quads(rng, side: int, per_page: int, buckets, h_rec: int) -> np.ndarray:
    """per_page word quads on a side x side canvas, in rows of words whose
    aspect ratios send them to each width bucket in turn (rec widths stay
    inside their bucket with a 10% margin); every 7th quad is rotated."""
    u = side / 960.0
    h = 16 * u
    bs = sorted(buckets)
    lows = [0.5 * bs[0]] + bs[:-1]
    qs: list = []
    k = 0
    y = 20 * u
    while len(qs) < per_page and y + 1.3 * h < side:
        x = 15 * u
        while len(qs) < per_page:
            b = k % len(bs)
            span = bs[b] - lows[b]
            w = rng.uniform(lows[b] + 0.1 * span, bs[b] - 0.1 * span) / h_rec * h
            if x + w + 0.3 * h > side - 5 * u:
                break
            if len(qs) % 7 == 3:  # rotated quad: the general gather path
                qs.append([[x, y], [x + w, y + 0.3 * h],
                           [x + w - 0.3 * h, y + 1.3 * h], [x - 0.3 * h, y + h]])
            else:
                qs.append([[x, y], [x + w, y], [x + w, y + h], [x, y + h]])
            x += w + 12 * u
            k += 1
        y += 22 * u
    if len(qs) < per_page:
        raise AssertionError(f"only {len(qs)} of {per_page} quads fit the canvas")
    return np.asarray(qs, np.float32)


def phase_recognizer(recognizer, n_pages: int, side: int, per_page: int) -> dict:
    """A served load through the public ``Recognizer.recognize_pages``:
    per_page word quads on each page, axis-aligned and rotated, in every
    width bucket. The first call sets up cuDNN and cuBLAS for the shapes;
    the second is timed."""
    from ocr_system_tpu_torch.engine.recognizer import _first_ge
    from ocr_system_tpu_torch.ops.sampling import axis_aligned_mask
    from ocr_system_tpu_torch.utils.smoke import draw_page

    s = recognizer.settings
    rng = np.random.default_rng(SEED + 1)
    pages = [draw_page(rng, side, side) for _ in range(n_pages)]
    quads = [served_quads(rng, side, per_page, s.rec_width_buckets, s.rec_image_height)
             for _ in range(n_pages)]
    flat = np.concatenate(quads)
    aspect = (np.linalg.norm(flat[:, 1] - flat[:, 0], axis=1)
              / np.linalg.norm(flat[:, 3] - flat[:, 0], axis=1))
    buckets = sorted(s.rec_width_buckets)
    hit = [_first_ge(buckets, w) for w in np.clip(aspect * s.rec_image_height, 16, None)]
    by_bucket = {b: hit.count(b) for b in buckets}
    rotated = int((~axis_aligned_mask(flat)).sum())
    if min(by_bucket.values()) == 0 or rotated == 0 or rotated == len(flat):
        raise AssertionError(f"the quads miss a bucket or a path: {by_bucket}, {rotated} rotated")
    t = time.perf_counter()
    recognizer.recognize_pages(pages, quads)
    first_s = time.perf_counter() - t
    reset_counts()
    t = time.perf_counter()
    res = recognizer.recognize_pages(pages, quads)
    sec = time.perf_counter() - t
    launched = counts()
    if [len(r) for r in res] != [len(q) for q in quads]:
        raise AssertionError("recognize_pages returned the wrong result count")
    if not all(isinstance(r.text, str) and math.isfinite(r.confidence)
               for row in res for r in row):
        raise AssertionError("non-finite recognition confidence")
    if recognizer.device.type == "cuda" and launched["crop"] < len(buckets):
        raise AssertionError(f"the crop kernel missed a width bucket: {launched}")
    return {"phase": "recognizer", "pages": n_pages, "quads": len(flat),
            "quads_by_bucket": by_bucket, "rotated": rotated, "launches": launched,
            "first_wall_s": first_s, "wall_s": sec}


def phase_engine(engine, pages, rotated: int | None) -> dict:
    """One wave through ``TorchOCREngine.process_pages``; only page
    ``rotated`` is deskewed."""
    reset_counts()
    t = time.perf_counter()
    outs = engine.process_pages(pages)
    sec = time.perf_counter() - t
    launched = counts()
    words = check_outputs(outs, pages)
    for k, (out, page) in enumerate(zip(outs, pages)):
        # the overlay image is the deskewed page the boxes were found on
        turned = not np.array_equal(out.processed_image, page.pixels)
        if turned != (k == rotated):
            raise AssertionError(f"page {k + 1}: deskew {'ran' if turned else 'did not run'}")
    if engine.recognizer.device.type == "cuda" and (
            launched["enhance"] < 1 + (rotated is not None) or launched["crop"] <= 0):
        raise AssertionError(f"kernels not on the path: {launched}")
    return {"phase": "engine", "pages": len(pages), "words": words,
            "launches": launched, "stage_ms": engine.stage_ms, "wall_s": sec,
            "pages_per_s": len(pages) / sec}


def track_dispatches(recognizer) -> dict:
    """Count, from now on, the recognizer's dispatches (one per width-
    bucketed batch of a call's pages), the crops they decode and the crop
    kernel launches they make."""
    from ocr_system_tpu_torch.kernels import crop

    seen = {"dispatches": 0, "crops": 0, "crop_launches": 0}
    run = type(recognizer)._rec_on_stack

    def counted(stack_dev, row_targets, row_quads, results):
        before = crop.LAUNCHES.value
        run(recognizer, stack_dev, row_targets, row_quads, results)
        seen["dispatches"] += 1
        seen["crops"] += sum(len(q) for t, q in zip(row_targets, row_quads) if t >= 0)
        seen["crop_launches"] += crop.LAUNCHES.value - before

    recognizer._rec_on_stack = counted
    return seen


def phase_hybrid(engine, pages, expected: list[dict], min_text: float, min_boxes: float,
                 tag: str, leaders_any_length: bool = False,
                 also: dict[str, list[dict]] | None = None, routing_equal: bool = False,
                 hindi: int = 0, min_hindi_text: float = 0.0) -> dict:
    """One wave of forms through the served engine, each page held against
    the JAX package's record of it: at least ``min_text`` of the JAX words
    matched by a port word (IoU >= 0.9 and the same text; with
    ``leaders_any_length``, dot-leader runs of any length alike) and at
    least ``min_boxes`` by a port box (IoU >= 0.9), its selection marks
    (count and states) and handwriting boxes (count) equal; with
    ``routing_equal``, every matched word's recognizer and every page's
    rescue counts equal. The first ``hindi`` pages are Hindi forms: the
    Devanagari recognizer must have dispatched (and, on the card, launched
    the crop kernel), and the share of their words matched is reported
    against ``min_hindi_text`` (``hindi_bar_met``), ungated. Every miss is
    printed; any other shortfall prints the row and raises. ``also``:
    further records to report the exact text share against, ungated."""
    from ocr_system_tpu_torch.utils.smoke import compare_to_expected, page_record, text_share

    if engine.settings.rec_charset == "auto" and engine.devanagari is None:
        raise AssertionError(f"{tag}: the Devanagari recognizer was not built")
    deva = track_dispatches(engine.devanagari) if engine.devanagari is not None else None
    reset_counts()
    try:
        t = time.perf_counter()
        outs = engine.process_pages(pages)
        sec = time.perf_counter() - t
        launched = counts()
    finally:
        if deva is not None:
            del engine.devanagari._rec_on_stack
    check_outputs(outs, pages)
    records = [page_record(*r) for r in zip(outs, engine.routed, engine.rescued)]
    per_page = [compare_to_expected(e, r) for e, r in zip(expected, records)]
    n = sum(c["words"] for c in per_page)
    exact = sum(c["matched"] for c in per_page)
    leaders = sum(c["matched_leaders"] for c in per_page)
    matched = leaders if leaders_any_length else exact
    boxes = sum(c["boxes_matched"] for c in per_page)
    key = "matched_leaders" if leaders_any_length else "matched"
    n_hindi = sum(c["words"] for c in per_page[:hindi])
    hindi_matched = sum(c[key] for c in per_page[:hindi])
    for k, c in enumerate(per_page):
        for miss in c["misses"]:
            emit({"phase": tag, "page": k + 1, "miss": miss})
        for miss in c["recognizer_misses"]:
            emit({"phase": tag, "page": k + 1, "recognizer_miss": miss})
        if c["rescued_ok"] is False:
            emit({"phase": tag, "page": k + 1, "rescued": records[k]["rescued"],
                  "rescued_expected": expected[k]["rescued"]})
    row = {"phase": tag, "pages": len(pages), "words_expected": n, "words_matched": exact,
           "text_share": exact / max(n, 1),
           "words_matched_leaders_any_length": leaders,
           "text_share_leaders_any_length": leaders / max(n, 1),
           "gated": "leaders_any_length" if leaders_any_length else "exact",
           "min_text_share": min_text,
           "boxes_matched": boxes, "box_share": boxes / max(n, 1), "min_box_share": min_boxes,
           "hindi_pages": hindi, "hindi_words_expected": n_hindi,
           "hindi_words_matched": hindi_matched,
           "hindi_text_share": hindi_matched / max(n_hindi, 1),
           "min_hindi_text_share": min_hindi_text,
           "words": sum(len(r["word"]) for r in records),
           "devanagari_words": sum(w["recognizer"] == "devanagari"
                                   for r in records for w in r["word"]),
           "recognizer_misses": sum(len(c["recognizer_misses"]) for c in per_page),
           "rescued": [r["rescued"] for r in records],
           "rescued_ok": [c["rescued_ok"] for c in per_page],
           "routing_gated": routing_equal,
           "devanagari_dispatch": deva,
           "selection_marks": sum(len(r["selection_mark"]) for r in records),
           "handwriting": sum(len(r["handwriting"]) for r in records),
           "marks_ok": [c["marks_ok"] for c in per_page],
           "handwriting_ok": [c["handwriting_ok"] for c in per_page],
           "text_share_vs": {k: text_share(v, records) for k, v in (also or {}).items()},
           "hindi_text_share_vs": {k: text_share(v[:hindi], records[:hindi])
                                   for k, v in (also or {}).items() if hindi},
           "launches": launched, "stage_ms": dict(engine.stage_ms), "wall_s": sec,
           "pages_per_s": len(pages) / sec}
    failed = []
    if len(outs) != len(expected) or matched < min_text * n or boxes < min_boxes * n:
        failed.append(f"{matched} (text, {row['gated']}) and {boxes} (boxes) of {n} words "
                      f"matched, under {min_text:.3f} / {min_boxes:.3f}")
    if not all(row["marks_ok"]) or not all(row["handwriting_ok"]):
        failed.append("marks or handwriting differ")
    if routing_equal and (row["recognizer_misses"] or not all(row["rescued_ok"])):
        failed.append(f"recognizers or rescue counts differ: {row['recognizer_misses']} "
                      f"words, {row['rescued_ok']}")
    if hindi and (deva is None or deva["dispatches"] <= 0 or (
            engine.recognizer.device.type == "cuda" and deva["crop_launches"] <= 0)):
        failed.append(f"the Devanagari recognizer did not run: {deva}")
    if engine.recognizer.device.type == "cuda" and (
            launched["enhance"] <= 0 or launched["crop"] <= 0):
        failed.append(f"kernels not on the path: {launched}")
    # the Hindi pages' bar is reported, met or not, and does not fail the
    # phase: bf16 detection rounding moves small Devanagari boxes, and the
    # re-segmentation and rescues amplify it (PERF.md, Findings)
    row["hindi_bar_met"] = hindi_matched >= min_hindi_text * n_hindi
    if failed:
        emit({**row, "failed": failed})
        raise AssertionError(f"{tag}: " + "; ".join(failed))
    return row


def reference_spread(expected: dict, hindi: int) -> dict:
    """The JAX package's bf16 records against its float32 ones: the share
    of the float32 words matched with dot-leader runs of any length alike,
    per wave, and on the mixed wave's first ``hindi`` (Hindi) pages."""
    from ocr_system_tpu_torch.utils.smoke import compare_to_expected

    def share(f32, b16):
        rows = [compare_to_expected(a, b) for a, b in zip(f32, b16)]
        return sum(r["matched_leaders"] for r in rows) / max(sum(r["words"] for r in rows), 1)

    out = {k: share(expected[k]["float32"], expected[k]["bfloat16"]) for k in ("pages", "mixed")}
    out["mixed_hindi"] = share(expected["mixed"]["float32"][:hindi],
                               expected["mixed"]["bfloat16"][:hindi])
    return out


def phase_glue(engine, dtype: str) -> dict:
    """Glue split's re-recognition: the committed glued-lines page, its
    lines' boxes and glued decodes through the engine's glue split pass
    (the rec of both halves of each split goes through the crop kernel).
    The boxes and texts after the pass must equal the JAX package's record
    at ``dtype``, with at least one split, and the crop kernel must
    launch."""
    from ocr_system_tpu_torch.engine.detector import DetResult
    from ocr_system_tpu_torch.engine.host_image import rgb_to_gray
    from ocr_system_tpu_torch.engine.recognizer import RecResult
    from ocr_system_tpu_torch.ops.boxes import DetectedBox
    from ocr_system_tpu_torch.utils.smoke import glued_lines

    page, quads, texts, expected = glued_lines()
    want = expected[dtype]
    det = [DetResult(boxes=[DetectedBox(q.copy(), expected["score"]) for q in quads],
                     skew_angle=0.0, page=page, gray=rgb_to_gray(page))]
    recs = [[RecResult(t, expected["confidence"]) for t in texts]]
    reset_counts()
    t = time.perf_counter()
    engine._split_glued(det, recs, [engine.recognizer])
    sec = time.perf_counter() - t
    launched = counts()
    got_texts = [r.text for r in recs[0]]
    got_quads = [b.quad.tolist() for b in det[0].boxes]
    row = {"phase": f"glue_{dtype}", "lines": len(quads), "boxes_after": len(got_quads),
           "texts": got_texts, "texts_equal": got_texts == want["texts"],
           "quads_equal": got_quads == want["quads"], "launches": launched,
           "ms": sec * 1e3}
    if len(got_quads) <= len(quads) or not (row["texts_equal"] and row["quads_equal"]):
        raise AssertionError(f"glue split differs from the JAX record: {row}, want {want}")
    if engine.recognizer.device.type == "cuda" and launched["crop"] <= 0:
        raise AssertionError(f"glue split: the crop kernel did not launch: {launched}")
    return row


BUCKETS = (256, 512, 1024, 2048)  # the extractor's token windows


def phase_extract(extractor, docs: dict, expected: dict, tag: str, exact: bool,
                  min_share: float = 1.0, smi: str = "", buckets=BUCKETS) -> dict:
    """The layout extractor on the JAX record's inputs (``docs``: name ->
    ``extract_from_layout`` arguments), each held against the JAX package's
    record of it (``expected``: name -> utils/smoke.result_record). One pass
    over every document sets the card up for its window; the second is
    timed per document and checked. ``exact``: every document's fields
    equal in key, value and type, in order, its form type and raw_response
    equal, confidences within 1e-3; else at least ``min_share`` of the
    expected fields equal in key, value and type (misses printed per
    document). Then the forward pass alone at each token window of
    ``buckets`` (CUDA events on the card, the host clock on the CPU)."""
    from ocr_system_tpu_torch.utils.smoke import compare_fields, result_record

    for doc in docs.values():
        extractor.extract_from_layout(*doc)
    ms, rows = {}, {}
    for name, doc in docs.items():
        t = time.perf_counter()
        got = extractor.extract_from_layout(*doc)
        ms[name] = (time.perf_counter() - t) * 1e3
        rows[name] = compare_fields(expected[name], result_record(got))
    n = sum(r["fields"] for r in rows.values())
    matched = sum(r["matched"] for r in rows.values())
    for name, r in rows.items():
        if r["misses"] or r["extra"]:
            emit({"phase": tag, "doc": name, "misses": r["misses"], "extra": r["extra"]})
    conf = [r["max_conf_diff"] for r in rows.values() if r["max_conf_diff"] is not None]
    row = {"phase": tag, "docs": len(docs), "fields_expected": n, "fields_matched": matched,
           "field_share": matched / max(n, 1),
           "docs_equal": sum(r["fields_equal"] for r in rows.values()),
           "form_types_equal": sum(r["form_type_equal"] for r in rows.values()),
           "raw_responses_equal": sum(r["raw_response_equal"] for r in rows.values()),
           "max_conf_diff": max(conf, default=None), "gated": "exact" if exact else min_share,
           "ms_per_doc": ms, "forward": time_forward(extractor, buckets),
           "nvidia_smi": smi}
    failed = []
    if exact and not all(r["fields_equal"] and r["form_type_equal"] and r["raw_response_equal"]
                         and r["max_conf_diff"] <= 1e-3 for r in rows.values()):
        failed.append("documents differ from the JAX record: " + ", ".join(
            k for k, r in rows.items() if not (r["fields_equal"] and r["form_type_equal"]
                                               and r["raw_response_equal"]
                                               and r["max_conf_diff"] <= 1e-3)))
    if matched < min_share * n:
        failed.append(f"{matched} of {n} fields matched, under {min_share}")
    if failed:
        emit({**row, "failed": failed})
        raise AssertionError(f"{tag}: " + "; ".join(failed))
    return row


def time_forward(extractor, buckets) -> dict:
    """ms of the extractor's forward pass alone per token window, on
    seeded tokens that fill it: CUDA events on the card (``cuda_ms``), the
    host clock (one call after one untimed) on the CPU."""
    import torch

    from ocr_system_tpu_torch.models.layout_extractor import COORD_BUCKETS

    rng = np.random.default_rng(SEED + 4)
    dev = extractor.device
    out = {}
    for n in buckets:
        ids = torch.from_numpy(rng.integers(1, extractor.charset.size, (1, n))).to(dev)
        boxes = torch.from_numpy(np.sort(rng.integers(0, COORD_BUCKETS, (1, n, 4)), -1)).to(dev)
        mask = torch.ones((1, n), dtype=torch.long, device=dev)

        def fn():
            with torch.inference_mode():
                return extractor.model(ids, boxes, mask, extractor.dtype)

        if dev.type == "cuda":
            out[n] = {"ms": cuda_ms(fn, 10)}
        else:
            fn()
            t = time.perf_counter()
            fn()
            out[n] = {"host_ms": (time.perf_counter() - t) * 1e3}
    return out


def phase_extract_e2e(orch, pages, expected: dict, tag: str, exact: bool,
                      smi: str = "") -> dict:
    """A wave of forms through the served engine, then its pages as one
    document through ``ExtractionOrchestrator.fields_for``: fields, field
    rows and validation report against the JAX orchestrator's record on
    the JAX engine's own OCR of the same wave (``expected``). ``exact``:
    the fields equal in key, value and type, in order, with form type and
    raw_response, confidences within 1e-3; every field row's key, value,
    type and page equal, its key and value boxes matched to the same text
    within 0.5 px; the validation report equal. Else the field share is
    reported, ungated. The kernels must launch on the card."""
    from ocr_system_tpu_torch.engine.pipeline import document_result
    from ocr_system_tpu_torch.utils import smoke

    reset_counts()
    t = time.perf_counter()
    outs = orch.engine.process_pages(pages)
    ocr_s = time.perf_counter() - t
    launched = counts()
    check_outputs(outs, pages)
    t = time.perf_counter()
    result, rows, report = orch.fields_for(document_result(outs))
    extract_s = time.perf_counter() - t
    got = {"result": smoke.result_record(result), "rows": smoke.rows_record(rows),
           "report": smoke.report_record(report)}
    fields = smoke.compare_fields(expected["result"], got["result"])
    cmp_rows = smoke.compare_rows(expected["rows"], got["rows"], 1e-3, 0.5)
    report_equal = got["report"] == expected["report"]
    if exact:  # ungated, a missing field shifts every later row: not listed
        for miss in cmp_rows["rows_differing"]:
            emit({"phase": tag, "row_differs": miss})
    row = {"phase": tag, "pages": len(pages), "fields_expected": fields["fields"],
           "fields_matched": fields["matched"],
           "field_share": fields["matched"] / max(fields["fields"], 1),
           "fields_equal": fields["fields_equal"], "max_conf_diff": fields["max_conf_diff"],
           "form_type": got["result"]["form_type"],
           "form_type_equal": fields["form_type_equal"],
           "raw_response_equal": fields["raw_response_equal"],
           "rows": len(rows), "rows_differing": len(cmp_rows["rows_differing"]),
           "rows_max_poly_diff": cmp_rows["max_poly_diff"],
           "report_equal": report_equal,
           "valid": report.valid_fields, "invalid": report.invalid_fields,
           "needs_review": report.needs_review, "gated": exact,
           "misses": fields["misses"], "extra": fields["extra"],
           "launches": launched, "ocr_wall_s": ocr_s, "extract_wall_s": extract_s,
           "nvidia_smi": smi}
    failed = []
    if exact and not (fields["fields_equal"] and fields["max_conf_diff"] <= 1e-3
                      and fields["form_type_equal"] and fields["raw_response_equal"]
                      and not cmp_rows["rows_differing"] and report_equal):
        failed.append("fields, field rows or validation report differ from the JAX record")
    if orch.engine.recognizer.device.type == "cuda" and (
            launched["enhance"] <= 0 or launched["crop"] <= 0):
        failed.append(f"kernels not on the path: {launched}")
    if failed:
        emit({**row, "failed": failed})
        raise AssertionError(f"{tag}: " + "; ".join(failed))
    return row


def phase_host_ops(page, iters: int = 3) -> dict:
    """ms per page on this host for the host image operations the hybrid
    path runs (median of ``iters``): the Gaussian threshold (classical
    detector), the mean threshold (marks and handwriting), both component
    orders and the dilations."""
    from ocr_system_tpu_torch.engine import host_image
    from ocr_system_tpu_torch.native import cc_label

    gray = host_image.rgb_to_gray(page)
    mask = host_image.adaptive_threshold(gray, "mean")
    ops = {
        "threshold_gaussian": lambda: host_image.adaptive_threshold(gray, "gaussian"),
        "threshold_mean": lambda: host_image.adaptive_threshold(gray, "mean"),
        "cc_raster_order": lambda: cc_label.label(mask),
        "cc_cv2_order": lambda: cc_label.label_cv2(mask),
        "cc_stats": lambda: cc_label.stats(*cc_label.label(mask)),
        "dilate_1x7": lambda: host_image.dilate(mask, (1, 7)),
        "dilate_3x3": lambda: host_image.dilate(mask, (3, 3)),
    }
    out = {}
    for name, fn in ops.items():
        times = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        out[name] = sorted(times)[len(times) // 2]
    return {"phase": "host_ops", "page": list(page.shape), "ms": out}


def phase_scheduler(engine, pages) -> dict:
    """Two waves through ``PageScheduler.process``: no retries, no failures."""
    from ocr_system_tpu_torch.engine.scheduler import PageScheduler

    sched = PageScheduler(engine, engine.settings)
    reset_counts()
    t = time.perf_counter()
    outs = sched.process(pages)
    sec = time.perf_counter() - t
    launched = counts()
    st = sched.stats
    if st.retried_pages or st.failed_pages:
        raise AssertionError(f"scheduler fell back: {st}")
    words = check_outputs(outs, pages)
    if engine.recognizer.device.type == "cuda" and (
            launched["enhance"] < st.waves or launched["crop"] <= 0):
        raise AssertionError(f"kernels not on the path: {launched}")
    return {"phase": "scheduler", "pages": len(pages), "waves": st.waves,
            "retried_pages": st.retried_pages, "failed_pages": st.failed_pages,
            "words": words, "launches": launched, "stage_ms": sched.timer.as_ms(),
            "wall_s": sec, "pages_per_s": len(pages) / sec}


# Spinning the card before the timed launches lets the host queue them
# all first, so the events time the kernels and not the host's launch
# overhead (a 15 us kernel is shorter than one Python wrapper call).
SPIN_CYCLES = 20_000_000  # ~10 ms at the H100's clock
FLUSH_BYTES = 256 << 20  # written before each cold launch: 5x the 50 MB L2


def cuda_ms(fn, iters: int = 20) -> float:
    """Warm: mean device time of fn() over iters back-to-back launches
    (CUDA events), after one untimed call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, flush, iters: int = 10) -> float:
    """Cold: mean device time of one fn() with the L2 evicted before it
    (FLUSH_BYTES written), the events around that launch alone."""
    import torch

    fn()
    total = 0.0
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flush.fill_(1)
        torch.cuda._sleep(SPIN_CYCLES // 10)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bound(nbytes: float, flops: float) -> dict:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes}


def agreement(got, ref) -> dict:
    """A kernel form against its plain version's float32 result: within
    1e-5 for float32; for bf16, equal to it rounded to bf16 but for one ulp
    on at most 0.1% of elements. Raises if not."""
    import torch

    from ocr_system_tpu_torch.utils.smoke import bf16_agrees, bf16_disagreement

    if got.dtype == torch.bfloat16:
        err = (got.float() - ref.to(torch.bfloat16).float()).abs().max().item()
        worst, share = bf16_disagreement(got, ref)
        if not bf16_agrees(got, ref):
            raise AssertionError(f"bf16 form disagrees: {worst} ulps on {share:.2e} of elements")
        return {"max_abs_err": err, "bf16_max_ulps": worst, "bf16_share_off": share}
    err = (got - ref).abs().max().item()
    if not err <= 1e-5:
        raise AssertionError(f"float32 form disagrees: {err}")
    return {"max_abs_err": err}


def measure_form(form: str, call, plain, ref, nbytes: float, flops: float, flush,
                 plain_iters: int = 5) -> dict:
    """Check one kernel form bit for bit against its plain version and
    against the plain version's float32 result ``ref``, then time it cold
    and warm beside its plain version."""
    import torch

    got = call()
    want = plain()
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"{form}: not bit for bit its plain version")
    row = {"form": form, **agreement(got, ref), "bit_exact": True}
    row["ms"] = cold_ms(call, flush)
    row["warm_ms"] = cuda_ms(call)
    row["plain_ms"] = cuda_ms(plain, plain_iters)
    row.update(bound(nbytes, flops))
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return row


def kernel_enhance(dev, flush) -> dict:
    """The enhance kernel at the det path's shape (8 u8 960 x 960 canvases ->
    (8, 3, 960, 960) in bf16, the serving compute dtype, and in float32),
    plus its RGB (JAX-signature) form at (8, 960, 960, 3)."""
    import torch

    from ocr_system_tpu_torch.kernels import enhance

    rng = np.random.default_rng(SEED + 2)
    gray = torch.from_numpy(rng.integers(0, 256, (8, 960, 960), np.uint8)).to(dev)
    means = enhance.gray_means(gray)
    rgb = torch.from_numpy(rng.random((8, 960, 960, 3), np.float32)).to(dev)
    b, h, w = gray.shape
    ref_gray = enhance.enhance_gray_plain(gray, means)
    ref_rgb = enhance.fused_enhance_plain(rgb)
    # contrast 3, row and column blur 9 + 9, unsharp 4, normalise 2 per plane
    flops_gray = b * h * w * (3 + 9 + 9 + 4 + 3 * 2)
    flops_rgb = 3 * b * h * w * (3 + 9 + 9 + 4 + 2)
    forms = []
    for dt, size in ((torch.bfloat16, 2), (torch.float32, 4)):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        forms.append(measure_form(
            f"gray_u8->{tag}", lambda dt=dt: enhance.enhance_gray(gray, means, dt),
            lambda dt=dt: enhance.enhance_gray_plain(gray, means, dt), ref_gray,
            gray.numel() + b * 3 * h * w * size, flops_gray, flush))
    for dt, size in ((torch.bfloat16, 2), (torch.float32, 4)):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        forms.append(measure_form(
            f"rgb_f32->{tag}", lambda dt=dt: enhance.fused_enhance(rgb, out_dtype=dt),
            lambda dt=dt: enhance.fused_enhance_plain(rgb, out_dtype=dt), ref_rgb,
            rgb.numel() * (4 + size), flops_rgb, flush))
    # the kernels line reports the detector's serving form
    return {"name": "enhance", **forms[0], "library_ms": None, "shape": [b, h, w],
            "forms": forms}


def crop_case(rng, pages_n: int, side: int, n: int, width: int):
    """Boxes as the recognizer makes them, plus the hard cases: off-page,
    unaligned widths, w_valid < W, and boxes taller than 112 px."""
    x0 = rng.uniform(-20, side - 100, (pages_n, n))
    y0 = rng.uniform(-10, side - 60, (pages_n, n))
    h = rng.uniform(12, 60, (pages_n, n))
    h[:, ::8] = rng.uniform(113, 300, (pages_n, len(range(0, n, 8))))
    wv = rng.integers(16, width + 1, (pages_n, n)).astype(np.int32)
    w = h * width / 48.0  # quads extended to the bucket, as the recognizer does
    aabbs = np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.float32)
    return aabbs, wv


def kernel_crop(dev, flush) -> dict:
    """The crop kernel at the rec path's shape: 8 canvases of 960 x 960 with
    160 boxes each, at every rec width bucket (320, 640, 1280), in bf16
    (the serving compute dtype) and float32."""
    import torch
    import torch.nn.functional as F

    from ocr_system_tpu_torch.kernels import crop

    rng = np.random.default_rng(SEED + 3)
    pages = torch.from_numpy(rng.integers(0, 256, (8, 960, 960), np.uint8)).to(dev)
    forms = []
    for width in (320, 640, 1280):
        aabbs_np, wv_np = crop_case(rng, 8, 960, 160, width)
        aabbs = torch.from_numpy(aabbs_np).to(dev)
        wv = torch.from_numpy(wv_np).to(dev)
        shape = (48, width)
        ref = crop.crop_boxes_plain(pages, aabbs, wv, shape)
        # yardstick only: grid_sample's bilinear with border padding on
        # the same sample points (no w_valid mask, float32 out)
        p_f = pages[:, None].float() / 255.0
        steps_h = torch.arange(48, device=dev, dtype=torch.float32) / 47.0
        steps_w = torch.arange(width, device=dev, dtype=torch.float32) / (width - 1)
        bx = aabbs.view(8, 160, 1, 1, 4)
        gx = bx[..., 0] + (bx[..., 2] - bx[..., 0]) * steps_w.view(1, 1, 1, -1)
        gy = bx[..., 1] + (bx[..., 3] - bx[..., 1]) * steps_h.view(1, 1, -1, 1)
        grid = torch.stack([
            (gx * 2 / 959 - 1).expand(-1, -1, 48, -1),
            (gy * 2 / 959 - 1).expand(-1, -1, -1, width),
        ], -1).reshape(8, 160 * 48, width, 2)
        library_ms = cold_ms(lambda: F.grid_sample(
            p_f, grid, mode="bilinear", padding_mode="border", align_corners=True), flush)
        n_out = 8 * 160 * 48 * width
        for dt, size in ((torch.bfloat16, 2), (torch.float32, 4)):
            tag = "bf16" if dt == torch.bfloat16 else "f32"
            nbytes = pages.numel() + aabbs.numel() * 4 + wv.numel() * 4 + n_out * size
            row = measure_form(
                f"W{width}->{tag}", lambda dt=dt: crop.crop_boxes(pages, aabbs, wv, shape, dt),
                lambda dt=dt: crop.crop_boxes_plain(pages, aabbs, wv, shape, dt), ref,
                nbytes, n_out * 14, flush)
            forms.append({"width": width, **row, "library_ms": library_ms})
    # the kernels line reports the serving form at W = 1280 (the largest);
    # every form is printed in the kernels phase
    serving = next(f for f in forms if f["form"] == "W1280->bf16")
    return {"name": "crop", **serving, "forms": forms}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(REPO, PKG)):
        print(f"chip_smoke: {PKG}/ not found beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    t_all = time.perf_counter()
    dev = torch.device("cuda:0")

    # ---- phase 0: device and build ----
    t = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from ocr_system_tpu_torch.kernels import _build

    so = _build.build()
    _build.library()
    ptxas = [ln.strip() for ln in _build.build_log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "library": os.path.relpath(so, REPO),
          "build_s": time.perf_counter() - t, "ptxas": ptxas})

    # ---- phase 1: kernels against their plain versions ----
    t = time.perf_counter()
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    k_enh = kernel_enhance(dev, flush)
    k_crop = kernel_crop(dev, flush)
    del flush
    emit({"phase": "kernels", "enhance": k_enh, "crop": k_crop,
          "elapsed_s": time.perf_counter() - t})

    from ocr_system_tpu_torch.engine.host_image import rotate_cubic
    from ocr_system_tpu_torch.engine.preprocess import PageImage
    from ocr_system_tpu_torch.utils import smoke

    # ---- phase 2: the trained weights and the committed forms ----
    forms, expected = smoke.smoke_forms()
    hindi = smoke.hindi_forms()
    files = [*smoke.TRAINED.values(), str(smoke.FORMS), str(smoke.HINDI), str(smoke.EXPECTED),
             str(smoke.PACKAGE / "weights" / "extract.npz"), str(smoke.EXTRACT_EXPECTED)]
    emit({"phase": "assets", "mb": {os.path.relpath(f, REPO): os.path.getsize(f) / 1e6
                                    for f in files},
          "forms": list(forms.shape), "hindi_forms": list(hindi.shape),
          "expected_settings": expected["settings"],
          "expected_from": f"jax {expected['jax']} on the CPU, {sorted(expected['pages'])}",
          # how far the JAX package's own bf16 is from its float32 (the
          # leader-aware word share; on the mixed wave also its Hindi pages)
          "jax_bf16_vs_f32": reference_spread(expected, len(hindi))})

    def as_pages(arrays):
        return [PageImage(np.ascontiguousarray(p), i + 1) for i, p in enumerate(arrays)]

    # ---- phase 3: recognizer on explicit quads ----
    t = time.perf_counter()
    neural = smoke.build_engine(dev, **smoke.NEURAL)
    rec = phase_recognizer(neural.recognizer, 8, 960, per_page=160)
    emit({**rec, "elapsed_s": time.perf_counter() - t})

    # ---- phase 4: the neural engine, 4 forms, one turned by 3 degrees ----
    t = time.perf_counter()
    arrays = list(forms[1:5])  # (the first form carries a skew of its own)
    arrays[2] = rotate_cubic(arrays[2], 3.0)
    neural.process_pages(as_pages(arrays[:2]))  # first call: cuDNN/cuBLAS set-up
    eng = phase_engine(neural, as_pages(arrays), rotated=2)
    emit({**eng, "elapsed_s": time.perf_counter() - t})

    # ---- phase 5: the hybrid engine at float32 against the JAX package ----
    t = time.perf_counter()
    want = expected["pages"]
    hybrid32 = smoke.build_engine(dev, **expected["settings"], compute_dtype="float32")
    h32 = phase_hybrid(hybrid32, as_pages(forms), want["float32"], 0.98, 0.98, "hybrid_f32",
                       routing_equal=True)
    emit({**h32, "elapsed_s": time.perf_counter() - t})

    # ---- phase 5b: the mixed wave (the Hindi forms, then Latin forms) ----
    mixed = as_pages([*hindi, *forms[:expected["mixed_latin"]]])
    t = time.perf_counter()
    m32 = phase_hybrid(hybrid32, mixed, expected["mixed"]["float32"], 0.98, 0.98, "mixed_f32",
                       routing_equal=True, hindi=len(hindi))
    emit({**m32, "elapsed_s": time.perf_counter() - t})

    # ---- phase 6: the hybrid engine in bf16, the serving path ----
    # held against the JAX package's bf16 outputs: every box, and
    # smoke.BF16_WORD_SHARE of the words with dot-leader runs of any length
    # alike (bf16 rounding moves a leader's decode by a dot in both
    # packages: rec_bf16_probe.py)
    t = time.perf_counter()
    hybrid = smoke.build_engine(dev, **expected["settings"], compute_dtype="bfloat16")
    hybrid.process_pages(as_pages(forms[:2]))  # first call: cuDNN/cuBLAS set-up
    h16 = phase_hybrid(hybrid, as_pages(forms), want["bfloat16"], smoke.BF16_WORD_SHARE, 0.98,
                       "hybrid_bf16", leaders_any_length=True,
                       also={"jax_float32": want["float32"]})
    emit({**h16, "elapsed_s": time.perf_counter() - t})

    # ---- phase 6a: the mixed wave in bf16, its Hindi pages gated too ----
    t = time.perf_counter()
    m16 = phase_hybrid(hybrid, mixed, expected["mixed"]["bfloat16"], smoke.BF16_WORD_SHARE,
                       0.98, "mixed_bf16", leaders_any_length=True,
                       also={"jax_float32": expected["mixed"]["float32"]},
                       hindi=len(hindi), min_hindi_text=0.95)
    emit({**m16, "elapsed_s": time.perf_counter() - t})

    # ---- phase 6b: glue split's re-recognition, at both dtypes ----
    for engine, dtype in ((hybrid32, "float32"), (hybrid, "bfloat16")):
        emit(phase_glue(engine, dtype))

    # ---- phase 6c: field extraction, the trained 512 x 8 layout
    # transformer, on the JAX record's OCR words (16 one-page documents and
    # the Latin wave as one 8-page document), at both dtypes ----
    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.extract.layout_model import LayoutModelExtractor, get_extractor
    from ocr_system_tpu_torch.service.orchestrator import ExtractionOrchestrator

    docs = smoke.extract_documents(expected)
    want_ex = smoke.extract_expected()
    extractors = {}
    for dtype, tag in (("float32", "extract_f32"), ("bfloat16", "extract_bf16")):
        t = time.perf_counter()
        ex = extractors[dtype] = get_extractor(Settings(compute_dtype=dtype), device=dev)
        blocks = getattr(getattr(ex, "model", None), "blocks", ())
        if not (isinstance(ex, LayoutModelExtractor) and len(blocks) == 8
                and blocks[0].heads == 8 and ex.model.norm.weight.numel() == 512):
            raise AssertionError(f"get_extractor did not serve the trained 512 x 8 model: {ex}")
        emit({**phase_extract(ex, docs, want_ex["docs"][dtype], tag, dtype == "float32",
                              min_share=0.95, smi=smi),
              "elapsed_s": time.perf_counter() - t})

    # ---- phase 6d: page to fields: the served engine's Latin wave through
    # the orchestrator's extract, save and validate stages ----
    for engine, dtype in ((hybrid32, "float32"), (hybrid, "bfloat16")):
        t = time.perf_counter()
        orch = ExtractionOrchestrator(engine.settings, engine=engine,
                                      extractor=extractors[dtype])
        emit({**phase_extract_e2e(orch, as_pages(forms), want_ex["e2e"][dtype],
                                  f"extract_e2e_{dtype}", dtype == "float32", smi=smi),
              "elapsed_s": time.perf_counter() - t})
    del hybrid32, extractors

    # ---- phase 7: the Latin wave, then the mixed wave, through the
    # scheduler (its det worker routes the second wave's Hindi pages while
    # the first wave's rec runs) ----
    t = time.perf_counter()
    sch = phase_scheduler(hybrid, as_pages([*forms, *hindi, *forms[:expected["mixed_latin"]]]))
    emit({**sch, "elapsed_s": time.perf_counter() - t})

    # ---- phase 8: the host image operations on one form ----
    emit(phase_host_ops(forms[1]))

    sources = {
        "enhance": "ocr_system_tpu/kernels/preprocess_pallas.py:117",
        "crop": "ocr_system_tpu/kernels/crop_pallas.py:111",
    }
    kernels = []
    for k in (k_enh, k_crop):
        name = k["name"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"{PKG}/csrc/kernels.cu",
            "replaces": sources[name],
            "launches": h16["launches"][name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"],
            "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"], "library_ms": k["library_ms"],
            "form": k["form"], "warm_ms": k["warm_ms"],
            "share_of_bound": k["share_of_bound"],
        })
    emit({"kernels": kernels, "total_s": time.perf_counter() - t_all})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
