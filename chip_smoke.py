#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ocr_system_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout and holds each form of each one
(bf16 and float32 out) against its plain PyTorch version, bit for bit, at
the shapes the serving path gives it (8 pages at the 960 bucket, every rec
width; the rotate kernel on the 8 committed forms against
``host_image.rotate_cubic`` on the host; the ink-mask kernel on each of
them against its plain version and the classical detector's host mask),
timing it cold (the L2 evicted
before the launch; the kernels line reports this time for the serving
bf16 form) and warm. Then it runs
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
counts); the served detector's skew angles on the committed forms and six
turned copies (``utils/smoke.skew_pages``), each page's estimate and
applied angle bit for bit the JAX record's (``skew``; a page that differs
is printed with both packages' top two candidates and fails the phase);
glue split's re-recognition of the committed glued-lines page
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
orchestrator's at float32 (reported at bf16). The service: the port's
``create_app`` on ``App.serve`` on 127.0.0.1 (a real socket) with the
served engine, the trained extractor and a temporary storage root and
database takes ``assets/service_upload.pdf`` (the 8 Latin forms as a
scanned PDF) as a multipart upload with ``auto_extract``; once the
polled extraction completes, its fields, rows, validation counts and
JSON and CSV exports are held against the JAX application's
(``assets/service_expected.json``: equal at float32, the share reported
at bf16), the XLSX, PDF and page-image responses are checked, ``/health``
and ``/api/stats/devices`` must name the card, and the rasterization
tier that served, the upload's wall seconds and the processing log's
stage times are printed. Training: each trainer (SVTR with CTC, DBNet
with the DB loss, the 512 x 8 layout transformer) takes 3 steps of its
step function on its committed batch (``assets/train_batches.npz``, drawn
by the JAX package's iterators at the train_models CLI's defaults) from
the trained weights, at float32 (TF32 off for the phase) and at bf16; the
losses, the first step's gradient norm, the parameter-group norms and the
first and last BatchNorm's statistics are held against the JAX package's
record of the same steps (``assets/train_expected.json``): at float32
within 4 times the JAX package's own spread under rounding changes
(``assets/train_spread.json``, train_spread_probe.py; two layout head
norms widened to the JAX record's own distance from exact arithmetic, the
cause shown in the run), and the first step within 2^-15 of the same
steps at float64 - a bar that the same steps with TF32 on must miss (the
``tf32_control`` phases); at bf16 reported, against the JAX bf16 record
as it is and with every operation rounded. Each phase prints its step ms
(CUDA events, steps 2-3) and peak memory. Then ``train_layout`` runs 20
steps at 512 x 8, batch 32, bf16, end to end through its own PIL-free form
generator, and prints its losses, then steps/s over 20 more steps and the
device's idle share over 20 more under the profiler; the rec and det
trainers the same way at the CLI batch on their own rendering iterators
(the fonts come with the package). Before training: the renderer's fonts
and PIL's text layout on this machine; the served hybrid engine at
float32 on 4 committed forms at each other detector setting (page wire 2
and 8 bits, prob wire 1, 4 and 8 bits, contrast off, adaptive
binarization on), held against the JAX engine's words
(``assets/eval_expected.json``), enhance launching exactly where the JAX
detector runs its Pallas kernel; and the quality evaluation
(training/evaluate.py: recognizer, end to end with the hybrid, classical
and Hindi rows, form and field extraction, forms through the engine,
signatures) at float32 and bf16 on the lines and pages the JAX package
drew (``assets/eval_renders.npz``, replayed), each item and score held
against the JAX record at float32 and reported at bf16, with the share of
each phase spent in edit distances.

Last, the parallel layer (core/mesh.py, parallel/; the multichip_*
phases): the default mesh (``MESH_SHAPE``/``Settings.mesh_shape``,
``dp=-1``) must be dp over every visible card; the served engine at
float32 runs the 8 Latin forms under it and then under a virtual dp=4
mesh (this card named 4 times; 2 pages a shard): 569 of 569 words as the
JAX record, the same records at dp=4 as at dp=1, and the enhance and crop
kernels launched on every dp shard; field extraction through
``get_extractor`` under a virtual sp=4 mesh serves ring attention: the 17
documents' 146 fields equal to the JAX record, and at 2048 tokens every
output within 1e-4 of the dense forward's largest value, with the forward
ms of both; the three trainers' float32 steps over virtual meshes (rec and
det dp=4, layout dp=2 x tp=2) within the bar each one-device step was
held to, and their BatchNorm running statistics against the one-device
step's within the same bar; the 512 x 8 extractor's blocks as 4 GPipe
stages of 2 with 8 microbatches, forward within 1e-5 and gradients within
1e-4 of the serial stack; and ``utils/multichip.dryrun_multichip`` on the
virtual 4-way mesh. A virtual mesh's times measure the schedule on one
card, not multi-card speed; the kernels line adds each kernel's launches
per dp shard of the virtual wave.

The native host ops (``native/cc_label.cpp``, ``native/ink_walk.cpp``):
the ``native`` phase builds their library with g++ from the checkout
(version and seconds printed), records what the served detector hands
them on the 8 Latin and 4 Hindi committed forms (the gray page and its
quads before the ink walk, the probability-map box path's maps at
det_prob_wire_bits 4) and holds each op against its plain version
(``native/plain.py``): connected components in both label orders and their
statistics on the pages' ink masks, the fused analysis at stride 1 and 2,
the batch ink walk; labels, counts, boxes and quads equal, sums and
moments within ``NATIVE_SUM_RTOL``; ms per page of each, native and plain.
Every wave phase (hybrid, mixed, scheduler, each detector setting) must
call the native ops (``NATIVE_ON_WAVE``; ``cc_analyze_u8`` too at a prob
wire width), and ``host_ops`` times them beside the plain versions. The
``scripts`` phase runs the port's entry points for the JAX package's
scripts once each: ``db.init_db`` (also through ``python -m``),
``db.db_admin tables`` and ``check`` on a temporary sqlite file,
``utils.debug_engine`` on committed form 1 as a one-page scanned PDF,
``utils.demo``, ``training.compare_extractors --forms 2`` and
``training.diag_forms --pages 1``, each with its expected shape of output.

Each phase prints one JSON line; then the ``native`` line (each native
op's calls on the served waves and its ms against its plain version on
this host), one line with every kernel's numbers, then the card's
``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``. Any failed check raises: the exit code is
then nonzero and no result line is printed. Without a CUDA device, or
outside a checkout of the repository, it exits 1 at once.

The phase functions take an engine and pages, so the CPU tests can run
them at a tiny size.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PKG = "ocr_system_tpu_torch"
SEED = 1234
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # float32 outside the tensor cores
H100_F64_FLOPS = 34e12  # float64 outside the tensor cores


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def native_counters() -> dict:
    """The native host ops' call counters, by C function."""
    from ocr_system_tpu_torch.native import cc_label, ink_walk

    return {**cc_label.CALLS, **ink_walk.CALLS}


def reset_counts() -> None:
    from ocr_system_tpu_torch.kernels import crop, enhance, ink_mask, rotate

    enhance.LAUNCHES.reset()
    crop.LAUNCHES.reset()
    rotate.LAUNCHES.reset()
    ink_mask.LAUNCHES.reset()
    for c in native_counters().values():
        c.reset()


def counts() -> dict[str, int]:
    from ocr_system_tpu_torch.kernels import crop, enhance, ink_mask, rotate

    return {"enhance": enhance.LAUNCHES.value, "crop": crop.LAUNCHES.value,
            "rotate": rotate.LAUNCHES.value, "ink_mask": ink_mask.LAUNCHES.value}


def native_calls() -> dict[str, int]:
    return {name: c.value for name, c in native_counters().items()}


# the native ops every served wave calls (the probability-map box path's
# cc_analyze_u8 only at det_prob_wire_bits 1, 4 and 8)
NATIVE_ON_WAVE = ("cc_label_u8", "cc_block_order", "cc_stats", "ink_expand_batch")


def native_misses(calls: dict, want=NATIVE_ON_WAVE) -> list[str]:
    return [f"native {name} not called: {calls}" for name in want if calls[name] <= 0]


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
            launched["enhance"] < 1 + (rotated is not None) or launched["crop"] <= 0
            or (launched["rotate"] > 0) != (rotated is not None)):
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
                 hindi: int = 0, min_hindi_text: float = 0.0,
                 records_out: list | None = None) -> dict:
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
    further records to report the exact text share against, ungated;
    ``records_out``: a list the pages' records are appended to."""
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
        native = native_calls()
    finally:
        if deva is not None:
            del engine.devanagari._rec_on_stack
    check_outputs(outs, pages)
    records = [page_record(*r) for r in zip(outs, engine.routed, engine.rescued)]
    if records_out is not None:
        records_out.extend(records)
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
           "launches": launched, "native_calls": native, "stage_ms": dict(engine.stage_ms),
           "wall_s": sec, "pages_per_s": len(pages) / sec}
    failed = native_misses(native)
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
    # the classical pass masks each page once, on the card
    if engine.recognizer.device.type == "cuda" and launched["ink_mask"] != len(pages):
        failed.append(f"the ink mask launched {launched['ink_mask']} times for "
                      f"{len(pages)} pages")
    # the Hindi pages' bar is reported, met or not, and does not fail the
    # phase: bf16 detection rounding moves small Devanagari boxes, and the
    # re-segmentation and rescues amplify it. The attribution (CHANGES.md,
    # the closing bring-up slice) puts the gap in detection (the port's bf16
    # recognition reads 57 of the 58 JAX bf16 words on the JAX boxes), and no
    # DBNet rounding point of XLA's closes it (ROADMAP Queue 3, closed residuals)
    row["hindi_bar_met"] = hindi_matched >= min_hindi_text * n_hindi
    if failed:
        emit({**row, "failed": failed})
        raise AssertionError(f"{tag}: " + "; ".join(failed))
    return row


def phase_skew(engine, want: dict, smi: str = "") -> dict:
    """The served detector's skew angles on the committed Latin and Hindi
    forms and their turned copies (``utils/smoke.skew_pages``) against the
    JAX record (``smoke_forms_expected.json``, "skew"), bit for bit: each
    page's forward estimate (float32) and the angle its ``DetResult``
    applied. A page that differs is printed with both packages' top two
    candidates and their scores, and the phase fails."""
    import torch

    from ocr_system_tpu_torch.engine.detector import _letterbox_host, unpack_wire
    from ocr_system_tpu_torch.kernels.enhance import to_unit
    from ocr_system_tpu_torch.ops import image_ops
    from ocr_system_tpu_torch.utils import smoke

    names, pages = smoke.skew_pages()
    rows = want["pages"]
    if [r["name"] for r in rows] != names or any(
            smoke.digest({"page": p}) != r["digest"] for p, r in zip(pages, rows)):
        raise AssertionError("skew: the pages are not those of the JAX record")
    neural = engine.detector.neural
    t = time.perf_counter()
    dets = engine.detector.detect_batch(pages)
    wall = time.perf_counter() - t
    packed = neural._pack_wire(np.stack([_letterbox_host(p, want["bucket"])[0] for p in pages]))
    est = neural._forward(packed)["angles"].cpu().numpy()

    def bits(v) -> int:
        return int(np.float32(v).view(np.uint32))

    differ = [i for i, r in enumerate(rows) if bits(est[i]) != bits(r["estimate"])
              or bits(dets[i].skew_angle) != bits(r["applied"])]
    if differ:
        gray = to_unit(unpack_wire(torch.from_numpy(packed[differ]).to(neural.device),
                                   neural.settings.det_wire_bits))
        angles, scores = image_ops.skew_search(gray)
        top = scores.topk(2, dim=1)
        for j, i in enumerate(differ):
            emit({"phase": "skew", "page": names[i], "estimate": float(est[i]),
                  "applied": dets[i].skew_angle, "jax_estimate": rows[i]["estimate"],
                  "jax_applied": rows[i]["applied"],
                  "top2": [[float(angles[k]), float(v)]
                           for k, v in zip(top.indices[j].tolist(), top.values[j].tolist())],
                  "jax_top2": rows[i]["top2"]})
    row = {"phase": "skew", "pages": len(pages), "turned": len(smoke.SKEW_TURNS),
           "pages_equal": len(pages) - len(differ),
           "applied": {n: d.skew_angle for n, d in zip(names, dets) if d.skew_angle},
           "device": str(neural.device), "wall_s": wall, "nvidia_smi": smi}
    if differ:
        emit({**row, "failed": [names[i] for i in differ]})
        raise AssertionError(f"skew: {len(differ)} pages differ from the JAX record")
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


def serve(app) -> tuple[str, object]:
    """``app.serve`` on 127.0.0.1 (a free port) in a thread of its own;
    returns the server's URL and a function that stops it."""
    import asyncio
    import threading

    loop = asyncio.new_event_loop()
    started = threading.Event()
    holder: dict = {}

    def run():
        asyncio.set_event_loop(loop)

        async def main():
            holder["stop"] = asyncio.Event()
            server = await app.serve("127.0.0.1", 0)
            holder["port"] = server.sockets[0].getsockname()[1]
            started.set()
            async with server:
                await holder["stop"].wait()

        try:
            loop.run_until_complete(main())
        finally:
            loop.close()

    thread = threading.Thread(target=run, daemon=True, name="smoke-server")
    thread.start()
    if not started.wait(30):
        raise AssertionError("the server did not start")

    def stop():
        loop.call_soon_threadsafe(holder["stop"].set)
        thread.join(30)

    return f"http://127.0.0.1:{holder['port']}", stop


def http(url: str, method: str = "GET", body: bytes | None = None,
         ctype: str = "") -> tuple[int, dict, bytes]:
    """One request over the socket: status, headers, body."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method=method,
                                 headers={"Content-Type": ctype} if ctype else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def ok_json(url: str, method: str = "GET", body: bytes | None = None, ctype: str = ""):
    status, _, data = http(url, method, body, ctype)
    if status >= 300:
        raise AssertionError(f"{method} {url}: {status} {data[:300]!r}")
    return json.loads(data)


def pil_version() -> str | None:
    """PIL's version where it imports here (the renderer tier of a PDF
    needs it), else None."""
    try:
        import PIL
    except ImportError:
        return None
    return PIL.__version__


def raster_tiers_agree(data: bytes, dpi: int) -> dict:
    """The upload's pages by the embedded-image tier, and by the renderer
    where PIL imports: whether they are pixel for pixel the same."""
    from ocr_system_tpu_torch.engine import pdf, preprocess

    embedded = preprocess._pdf_extract_images(data)
    if pil_version() is None:
        return {"embedded_pages": len(embedded), "render": "no PIL"}
    rendered = pdf.render_pdf(data, dpi=dpi)
    return {"embedded_pages": len(embedded), "render_pages": len(rendered),
            "equal": len(embedded) == len(rendered) and all(
                a.shape == b.shape and np.array_equal(a, b) for a, b in zip(embedded, rendered))}


def service_app(engine, extractor, root: str, dtype: str):
    """The port's ``create_app`` on ``engine`` and ``extractor``, at the
    upload's rasterization dpi, on a storage root and database under
    ``root``, its per-client rate limit raised for the poller; returns the
    app and its orchestrator."""
    from ocr_system_tpu_torch.api.app import ApiContext, create_app
    from ocr_system_tpu_torch.db.connection import Database
    from ocr_system_tpu_torch.service.orchestrator import ExtractionOrchestrator
    from ocr_system_tpu_torch.utils import smoke

    s = engine.settings.model_copy(update={
        "storage_root": os.path.join(root, dtype), "compute_dtype": dtype,
        "database_path": os.path.join(root, dtype, "app.db"),
        "pdf_raster_dpi": smoke.SERVICE_DPI, "warmup_on_start": False,
        # the phase polls ten times a second: above the default budgets of
        # 60 requests a minute and 1000 an hour per client
        "rate_limit_per_minute": 1_000_000, "rate_limit_per_hour": 1_000_000})
    db = Database(s.db_path)
    orch = ExtractionOrchestrator(s, engine=engine, extractor=extractor, db=db)
    return create_app(ApiContext(settings=s, db=db, orchestrator=orch)), orch


def phase_service(app, orch, data: bytes, expected: dict, tag: str, exact: bool,
                  smi: str = "", timeout_s: float = 300.0) -> dict:
    """An upload through the HTTP API on a real socket: ``App.serve`` on
    127.0.0.1, the PDF POSTed as multipart with ``auto_extract``, the
    extraction polled through ``/status`` to its end; then the current
    extraction, its four exports and the first processed page image. The
    fields, their rows, the validation counts and the JSON and CSV exports
    are held against the JAX application's record (``expected``): with
    ``exact``, fields equal in key, value, type and order, confidences
    within 1e-3, boxes within 0.5 px, validation counts, JSON and CSV
    (masked; floats within 1e-3) equal; else the field share is reported.
    Always: the XLSX opens as a zip with its sheet, the PDF export runs
    from ``%PDF-`` to ``%%EOF``, the page image is a JPEG, ``/health`` and
    ``/api/stats/devices`` answer 200 and name the engine's CUDA device,
    and on the card both kernels launch during the upload. Reports the
    rasterization tier that served, whether PIL imports, the upload's wall
    seconds and pages/s, and the stage times of the processing log; the
    upload's two rasterization tiers (where PIL imports) must agree pixel
    for pixel."""
    import io
    import zipfile

    import torch

    from ocr_system_tpu_torch.engine import preprocess
    from ocr_system_tpu_torch.utils import smoke

    url, stop = serve(app)
    failed = []
    try:
        body, ctype = smoke.multipart(data, smoke.SERVICE_UPLOAD.name, {"auto_extract": "true"})
        reset_counts()
        preprocess.RASTER_TIERS.clear()
        t0 = time.perf_counter()
        doc = ok_json(url + "/api/documents/upload", "POST", body, ctype)
        # one request every 0.1 s: the document until it lists its
        # extraction, the extraction's /status until it is "completed" (at
        # the save stage), then the document until it is (after validation)
        status, eid, polls = None, None, 0
        while time.perf_counter() - t0 < timeout_s:
            if eid is None or status["status"] == "completed":
                found = ok_json(f"{url}/api/documents/{doc['id']}")
                if found["status"] in ("completed", "failed"):
                    break
                eid = found["extractions"][0]["id"] if found["extractions"] else None
            if eid is not None:
                status = ok_json(f"{url}/api/extractions/{eid}/status")
                if status["status"] == "failed":
                    break
            polls += 1
            time.sleep(0.1)
        if eid is not None:
            status = ok_json(f"{url}/api/extractions/{eid}/status")
        wall = time.perf_counter() - t0
        launched = counts()
        tiers = dict(preprocess.RASTER_TIERS)
        if status is None or status["status"] != "completed":
            raise AssertionError(f"{tag}: extraction did not complete: {status}")
        ext = ok_json(f"{url}/api/extractions/document/{doc['id']}")
        exports = {}
        for fmt in ("json", "csv", "excel", "pdf"):
            code, headers, payload = http(f"{url}/api/exports/extraction/{ext['id']}/{fmt}")
            if code != 200:
                raise AssertionError(f"{tag}: export {fmt}: {code} {payload[:200]!r}")
            exports[fmt] = payload
        got = smoke.service_record(ext, exports["json"], exports["csv"])
        cmp = smoke.compare_service(expected, got, 1e-3, 0.5)
        sheet = zipfile.ZipFile(io.BytesIO(exports["excel"])).read("xl/worksheets/sheet1.xml")
        if b"<sheetData>" not in sheet or not got["fields"] or \
                got["fields"][0]["key"].encode() not in sheet.replace(b"&amp;", b"&"):
            failed.append("the XLSX export has no field sheet")
        if not (exports["pdf"].startswith(b"%PDF-") and exports["pdf"].rstrip().endswith(b"%%EOF")):
            failed.append("the PDF export is not a PDF")
        code, headers, jpeg = http(f"{url}/api/documents/{doc['id']}/processed-image/1")
        if code != 200 or jpeg[:2] != b"\xff\xd8" or jpeg[-2:] != b"\xff\xd9":
            failed.append(f"processed-image page 1: {code}, not a JPEG")
        health = http(url + "/health")
        devices = ok_json(url + "/api/stats/devices")["devices"]
        overview = ok_json(url + "/api/stats/overview")
    finally:
        stop()
    tiers_agree = raster_tiers_agree(data, orch.engine.settings.pdf_raster_dpi)
    logs = orch.repos.logs.list_for_document(doc["id"])
    stages = {f"{r['step']}_ms": r["duration_ms"] for r in logs
              if r["status"] == "completed" and r["duration_ms"] is not None}
    ocr_log = next((r for r in logs if r["step"] == "ocr" and r["status"] == "completed"), {})
    on_card = orch.engine.recognizer.device.type == "cuda"
    name = torch.cuda.get_device_name(0) if on_card else None
    pages = len(ext["page_dimensions"])
    row = {"phase": tag, "pages": pages,
           "raster_tier": tiers, "pil": pil_version(), "tiers_agree": tiers_agree,
           "upload_wall_s": wall, "pages_per_s": pages / wall,
           "polls": polls, "stage_ms": stages,
           "scheduler_ms": (ocr_log.get("details") or {}).get("stage_times_ms"),
           "fields_expected": cmp["fields"], "fields_matched": cmp["matched"],
           "field_share": cmp["field_share"], "fields_equal": cmp["fields_equal"],
           "rows_equal": cmp["rows_equal"], "rows_differing": cmp["rows_differing"],
           "max_conf_diff": cmp["max_conf_diff"], "max_poly_diff": cmp["max_poly_diff"],
           "validation": got["validation"], "validation_equal": cmp["validation_equal"],
           "json_equal": cmp["json_equal"], "csv_equal": cmp["csv_equal"],
           "markdown_equal": cmp["markdown_equal"], "form_type": got["form_type"],
           "layout_boxes": cmp["layout_boxes"], "export_bytes": {k: len(v) for k, v in
                                                                 exports.items()},
           "health": health[0], "devices": devices,
           "engine_devices": overview["engine"].get("devices"),
           "launches": launched, "gated": exact, "nvidia_smi": smi}
    if exact and not (cmp["fields_equal"] and cmp["rows_equal"] and cmp["validation_equal"]
                      and cmp["json_equal"] and cmp["csv_equal"]):
        failed.append("fields, rows, validation or exports differ from the JAX record")
    if tiers_agree.get("equal") is False:
        failed.append(f"the rasterization tiers disagree: {tiers_agree}")
    if health[0] != 200:
        failed.append(f"/health answered {health[0]}")
    if on_card and not (any(d.get("name") == name for d in devices)
                        and name in (overview["engine"].get("devices") or [])):
        failed.append(f"the CUDA device {name} is not named: {devices}")
    if on_card and (launched["enhance"] <= 0 or launched["crop"] <= 0):
        failed.append(f"kernels not on the path: {launched}")
    if failed:
        emit({**row, "failed": failed})
        raise AssertionError(f"{tag}: " + "; ".join(failed))
    return row


def phase_breakdown(engine, pages, want_records: list[dict], tag: str, smi: str = "") -> dict:
    """``utils/profiler.det_rec_breakdown`` on one wave through the served
    engine: every key it returns, the card's name and power limit, and the
    kernels' launches during it. Gates: det_mfu and rec_mfu in (0, 1], both
    kernels launched, and the wave's words (text and box) equal to the wave
    phase's records of the same pages (``want_records``)."""
    from ocr_system_tpu_torch.utils.profiler import det_rec_breakdown
    from ocr_system_tpu_torch.utils.smoke import page_record

    outs = []
    rec_stage = engine.rec_stage

    def capture(pages_, dets, t0=None):  # the breakdown's own wave output
        out = rec_stage(pages_, dets, t0)
        outs.append(out)
        return out

    engine.rec_stage = capture
    reset_counts()
    try:
        t = time.perf_counter()
        bd = det_rec_breakdown(engine, pages)
        sec = time.perf_counter() - t
        launched = counts()
    finally:
        del engine.rec_stage
    check_outputs(outs[0], pages)
    records = [page_record(*r) for r in zip(outs[0], engine.routed, engine.rescued)]
    same = [r["word"] == w["word"] for r, w in zip(records, want_records)]
    row = {"phase": tag, **bd, "nvidia_smi": smi, "launches": launched,
           "words_equal_wave_phase": same, "breakdown_s": sec}
    failed = []
    for key in ("det_mfu", "rec_mfu"):
        if not 0.0 < row.get(key, 0.0) <= 1.0:
            failed.append(f"{key} {row.get(key)} not in (0, 1]")
    if launched["enhance"] <= 0 or launched["crop"] <= 0:
        failed.append(f"kernels not launched during the breakdown: {launched}")
    if len(records) != len(want_records) or not all(same):
        failed.append(f"the breakdown's words differ from the wave phase's: {same}")
    if failed:
        emit({**row, "failed": failed})
        raise AssertionError(f"{tag}: " + "; ".join(failed))
    return row


def trace_kernels(path: str) -> list[tuple[str, float]]:
    """The CUDA kernel events of a Chrome trace: (name, duration us)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["dur"])) for e in events
            if e.get("cat") == "kernel" and "dur" in e]


def phase_trace(engine, pages, out_dir: str, smi: str = "") -> dict:
    """``utils/profiler.device_trace`` around one wave through the served
    engine, written into ``out_dir`` (then gzipped). Gate: the trace holds
    CUDA kernel events, the enhance and crop kernels among them. Reports the
    device's busy share over the wave (the union of the trace's kernel
    intervals over the wave's wall time) and the kernel time by name."""
    import glob
    import gzip
    import shutil

    import torch

    from ocr_system_tpu_torch.utils.profile_wave import device_busy_ms
    from ocr_system_tpu_torch.utils.profiler import device_trace

    os.makedirs(out_dir, exist_ok=True)
    before = set(glob.glob(os.path.join(out_dir, "*.json")))
    reset_counts()
    with device_trace(out_dir, engine.recognizer.device) as prof:
        t = time.perf_counter()
        engine.process_pages(pages)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    launched = counts()
    (path,) = set(glob.glob(os.path.join(out_dir, "*.json"))) - before
    spans = trace_kernels(path)
    by_name: dict[str, float] = {}
    for name, d in spans:
        by_name[name] = by_name.get(name, 0.0) + d / 1e3
    busy = device_busy_ms(prof)
    size = os.path.getsize(path)
    with open(path, "rb") as src, gzip.open(path + ".gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    os.remove(path)
    row = {"phase": "trace", "nvidia_smi": smi, "trace": os.path.relpath(path + ".gz", REPO),
           "trace_mb": size / 1e6, "kernel_events": len(spans), "launches": launched,
           "wall_ms": wall_ms, "device_busy_ms": busy,
           "device_busy_share": busy / wall_ms, "device_idle_share": 1.0 - busy / wall_ms,
           "kernel_ms_top": sorted(by_name.items(), key=lambda kv: -kv[1])[:12]}
    missing = [k for k in ("enhance_kernel", "crop_kernel")
               if not any(k in name for name, _ in spans)]
    if not spans or missing:
        emit({**row, "failed": missing})
        raise AssertionError(f"trace: no CUDA kernel events for {missing or 'any kernel'}")
    return row


CHAIN_TOL = 1e-5  # preprocess_chain: the card's image against the CPU's


def phase_preprocess_chain(dev, forms: np.ndarray, smi: str = "") -> dict:
    """``ops/image_ops.preprocess_page`` on the committed forms at 960, each
    turned by a seeded angle in +-10 degrees (the first under 0.5, which the
    deskew gate leaves alone), in all 8 flag combinations, on the card and
    with the same inputs on the CPU. Gate: the angle equal and the image
    within ``CHAIN_TOL``. Reports the card's ms per page (CUDA events, one
    call each, after one warm-up call)."""
    import itertools

    import torch

    from ocr_system_tpu_torch.engine.host_image import rotate_cubic
    from ocr_system_tpu_torch.ops.image_ops import preprocess_page

    rng = np.random.default_rng(SEED)
    angles = rng.uniform(-10.0, 10.0, len(forms))
    angles[0] = rng.uniform(-0.45, 0.45)
    pages = [torch.from_numpy(rotate_cubic(f, float(a))).float() / 255.0
             for f, a in zip(forms, angles)]
    preprocess_page(pages[1].to(dev))  # warm-up: cuFFT plans
    torch.cuda.synchronize()
    rows, failed, worst = {}, [], 0.0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for flags in itertools.product((False, True), repeat=3):
        ms, applied = [], []
        for k, page in enumerate(pages):
            x = page.to(dev)
            start.record()
            got, got_angle = preprocess_page(x, *flags)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            want, want_angle = preprocess_page(page, *flags)
            diff = float((got.cpu() - want).abs().max())
            worst = max(worst, diff)
            applied.append(float(got_angle))
            if float(got_angle) != float(want_angle) or diff > CHAIN_TOL:
                failed.append(f"{flags} page {k}: angle {float(got_angle)} / "
                              f"{float(want_angle)}, max diff {diff}")
        name = "deskew%d_contrast%d_binarize%d" % flags
        rows[name] = {"ms_per_page_median": float(np.median(ms)), "ms_per_page": ms,
                      "angles": applied}
    row = {"phase": "preprocess_chain", "nvidia_smi": smi, "pages": len(pages),
           "size": list(pages[0].shape), "turned_by": angles.tolist(), "tol": CHAIN_TOL,
           "max_abs_diff": worst, "flags": rows}
    if failed:
        emit({**row, "failed": failed})
        raise AssertionError("preprocess_chain: " + "; ".join(failed))
    return row


def phase_text_pdf(smi: str = "") -> dict:
    """The PDF parity tests' text PDF through ``engine/pdf.render_pdf`` on
    this machine. Gate: the text was drawn in the package's DejaVu Sans
    (``assets/fonts/DejaVuSans*.ttf``, ``pdf.FONTS_SERVED``). Reported,
    ungated: the share of pixels equal to the render committed from the
    JAX package on a host with raqm (``utils/smoke.TEXT_PDF_RENDER``); this
    machine's PIL lays text out glyph by glyph."""
    from ocr_system_tpu_torch.engine import pdf
    from ocr_system_tpu_torch.utils import smoke

    pdf.FONTS_SERVED.clear()
    t = time.perf_counter()
    page = pdf.render_pdf(smoke.text_pdf(), dpi=smoke.TEXT_PDF_DPI)[0]
    sec = time.perf_counter() - t
    served = dict(pdf.FONTS_SERVED)
    want = smoke.text_pdf_render()
    package = os.path.realpath(pdf.FONT_DIRS[0])
    ok = bool(served) and all(
        os.path.realpath(p).startswith(package + os.sep)
        and os.path.basename(p) in ("DejaVuSans.ttf", "DejaVuSans-Bold.ttf") for p in served)
    row = {"phase": "service_text_pdf", "nvidia_smi": smi, "fonts_served": served,
           "package_fonts": ok, "shape": list(page.shape), "render_s": sec,
           "pixels_equal_share": (float((page[..., 0] == want).mean())
                                  if page.shape[:2] == want.shape else None),
           "ink_pixels": int((page[..., 0] < 128).sum()),
           "ink_pixels_committed": int((want < 128).sum())}
    if not ok:
        emit({**row, "failed": "the text was not drawn in the package's DejaVu"})
        raise AssertionError(f"service_text_pdf: fonts served {served}")
    return row


def phase_host_ops(page, iters: int = 3) -> dict:
    """ms per page on this host for the host image operations the hybrid
    path runs (median of ``iters``): the Gaussian threshold (classical
    detector), the mean threshold (marks and handwriting), both component
    orders and their statistics, each by the native op (``*_native``) and
    by its plain version; the dilations; and the save stage's JPEG encoding
    of the page (quality 92, the default)."""
    from ocr_system_tpu_torch.engine import host_image
    from ocr_system_tpu_torch.engine.jpeg import encode_jpeg
    from ocr_system_tpu_torch.native import cc_label, plain

    gray = host_image.rgb_to_gray(page)
    mask = host_image.adaptive_threshold(gray, "mean")
    maskf = mask.astype(np.float32)

    ops = {
        "threshold_gaussian": lambda: host_image.adaptive_threshold(gray, "gaussian"),
        "threshold_mean": lambda: host_image.adaptive_threshold(gray, "mean"),
        "cc_raster_order": lambda: plain.label(mask),
        "cc_raster_order_native": lambda: cc_label.label(mask),
        "cc_cv2_order": lambda: plain.label_cv2(mask),
        "cc_cv2_order_native": lambda: cc_label.label_cv2(mask),
        "cc_stats": lambda: _label_stats(plain, mask, maskf),
        "cc_stats_native": lambda: _label_stats(cc_label, mask, maskf),
        "dilate_1x7": lambda: host_image.dilate(mask, (1, 7)),
        "dilate_3x3": lambda: host_image.dilate(mask, (3, 3)),
        "encode_jpeg": lambda: encode_jpeg(page, 92),
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


# the relative bar of the native sums and moments (float64, accumulated in
# raster order) against the plain version's (np.bincount, the same order):
# equal in practice; anything past rounding is a fault
NATIVE_SUM_RTOL = 1e-12
# each native function, its source, and the JAX package's op it ports
NATIVE_SOURCES = {
    "cc_label_u8": ("cc_label.cpp", "ocr_system_tpu/native/cc_label.cpp:54"),
    "cc_block_order": ("cc_label.cpp", "cv2.connectedComponentsWithStats, "
                       "ocr_system_tpu/engine/selection_marks.py:72"),
    "cc_stats": ("cc_label.cpp", "ocr_system_tpu/native/cc_label.cpp:110"),
    "cc_analyze_u8": ("cc_label.cpp", "ocr_system_tpu/native/cc_label.cpp:150"),
    "ink_expand_batch": ("ink_walk.cpp", "ocr_system_tpu/native/ink_walk.cpp:32"),
}


def served_native_inputs(engine, pages: list) -> list[dict]:
    """What the served detector hands the native ops on each page: its
    gray page and the axis-aligned quads before the ink walk, and the
    probability-map box path's binary map and probability map (the engine
    is built with a prob wire width), recorded during one ``detect_batch``."""
    from ocr_system_tpu_torch.engine import detector as det_mod
    from ocr_system_tpu_torch.native import cc_label

    seen: dict[str, list] = {"ink": [], "analyze": []}
    real_ink, real_analyze = det_mod.ink_expand_batch, cc_label.analyze

    def ink(gray, quads, *args):
        seen["ink"].append((gray.copy(), quads.copy()))
        return real_ink(gray, quads, *args)

    def analyze(binary, prob, stride=1, *args, **kw):
        seen["analyze"].append((np.array(binary, np.uint8), np.array(prob, np.float32), stride))
        return real_analyze(binary, prob, stride, *args, **kw)

    det_mod.ink_expand_batch, cc_label.analyze = ink, analyze
    try:
        engine.detector.detect_batch(pages)
    finally:
        det_mod.ink_expand_batch, cc_label.analyze = real_ink, real_analyze
    if not (len(seen["ink"]) == len(seen["analyze"]) == len(pages)):
        raise AssertionError(f"recorded {len(seen['ink'])} ink walks and "
                             f"{len(seen['analyze'])} analyses for {len(pages)} pages")
    return [{"gray": g, "quads": q, "binary": b, "prob": p}
            for (g, q), (b, p, _) in zip(seen["ink"], seen["analyze"])]


def phase_native(engine, pages: list, iters: int = 3, smi: str = "") -> dict:
    """The native host library: built from the checkout with g++ (version
    and seconds printed), then each native op held against its plain
    version (``native/plain.py``) on every page's served inputs (``engine``:
    a detector at det_prob_wire_bits 4): ``label`` on the mean (marks and
    handwriting) and Gaussian (classical) ink masks, the cv2 order,
    ``stats``, ``analyze`` at stride 1 on the probability map and at
    stride 2 on it pooled by 2, and ``ink_expand_batch`` on the detector's
    quads. Labels, counts, bboxes and quads must be equal, sums and moments
    within NATIVE_SUM_RTOL. ms per page on this host, native and plain, the
    median of ``iters`` runs over all pages."""
    from ocr_system_tpu_torch.engine import host_image
    from ocr_system_tpu_torch.native import build, cc_label, ink_walk, plain

    t = time.perf_counter()
    so = build.build()
    build.library()
    build_s = time.perf_counter() - t
    inputs = served_native_inputs(engine, pages)
    cases = []
    for inp in inputs:
        gray = inp["gray"]
        binary, prob = inp["binary"], inp["prob"]
        pooled = prob[: prob.shape[0] // 2 * 2, : prob.shape[1] // 2 * 2]
        pooled = pooled.reshape(pooled.shape[0] // 2, 2, -1, 2).mean(axis=(1, 3))
        for mask in (host_image.adaptive_threshold(gray, "mean"),
                     host_image.adaptive_threshold(gray, "gaussian")):
            cases.append((mask, mask.astype(np.float32), binary, prob, pooled, gray,
                          inp["quads"]))

    ops = {
        "cc_label_u8": lambda mod, c: mod.label(c[0]),
        "cc_block_order": lambda mod, c: mod.label_cv2(c[0]),
        "cc_stats": lambda mod, c: _label_stats(mod, c[0], c[1]),
        "cc_analyze_u8_stride1": lambda mod, c: mod.analyze(c[2], c[3], 1),
        "cc_analyze_u8_stride2": lambda mod, c: mod.analyze(c[2], c[4], 2),
        "ink_expand_batch": lambda mod, c: mod.ink_expand_batch(c[5], c[6].copy()),
    }
    rows, failed = {}, []
    for name, fn in ops.items():
        native = ink_walk if name == "ink_expand_batch" else cc_label
        worst, unequal = 0.0, 0
        for c in cases:
            got, want = fn(native, c), fn(plain, c)
            exact, close = _native_split(name, got, want)
            unequal += not all(np.array_equal(g, w) for g, w in exact)
            for g, w in close:
                rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-300)
                worst = max(worst, float(rel.max(initial=0.0)))
        ms = {}
        for label, mod in (("ms", native), ("plain_ms", plain)):
            runs = []
            for _ in range(iters):
                t = time.perf_counter()
                for c in cases[::2]:  # one case per page (the mean mask's)
                    fn(mod, c)
                runs.append((time.perf_counter() - t) * 1e3 / len(inputs))
            ms[label] = sorted(runs)[len(runs) // 2]
        rows[name] = {**ms, "speedup": ms["plain_ms"] / max(ms["ms"], 1e-9),
                      "cases": len(cases), "unequal": unequal, "max_rel_err": worst}
        if unequal or worst > NATIVE_SUM_RTOL:
            failed.append(f"{name}: {unequal} cases unequal, sums within {worst:.3g}")
    gxx = build.compiler_version(build.compiler())
    row = {"phase": "native", "library": os.path.relpath(so, REPO), "gxx": gxx,
           "cpu": build.cpu_model().split(" | ")[0], "build_s": build_s, "pages": len(inputs),
           "boxes": sum(len(i["quads"]) for i in inputs), "ops": rows,
           "sum_rtol": NATIVE_SUM_RTOL, "nvidia_smi": smi}
    if failed:
        emit({**row, "failed": failed})
        raise AssertionError("native: " + "; ".join(failed))
    return row


def _label_stats(mod, mask, prob):
    """A label, then its statistics, as the served callers do."""
    labels, n = mod.label(mask)
    return mod.stats(labels, prob, n)


def _native_split(name: str, got, want) -> tuple[list, list]:
    """A native op's outputs and its plain version's, split into the pairs
    that must be equal and the float64 sums held within the bar."""
    if name == "cc_stats":
        return [(got[0], want[0]), (got[2], want[2])], [(got[1], want[1])]
    if name.startswith("cc_analyze"):
        return ([(got[0], want[0]), (np.int64(got[1]), np.int64(want[1])),
                 (got[2], want[2]), (got[4], want[4])],
                [(got[3], want[3]), (got[5], want[5])])
    if name == "ink_expand_batch":
        return [(got, want)], []
    return [(got[0], want[0]), (np.int64(got[1]), np.int64(want[1]))], []


def phase_scripts(device, form: np.ndarray, root: str) -> dict:
    """The port's entry points for the JAX package's scripts, each once
    with its expected shape of output: ``db.init_db`` through ``python -m``
    and in this process, ``db.db_admin tables|check`` on a temporary sqlite
    file; ``utils.debug_engine`` on ``form`` (a one-page scanned PDF, the
    served engine with the trained weights); ``utils.demo`` with the
    trained weights; ``training.compare_extractors --forms 2`` and
    ``training.diag_forms --pages 1``. Seconds per entry point."""
    import contextlib
    import importlib
    import io

    from ocr_system_tpu_torch.core.config import reset_settings_cache
    from ocr_system_tpu_torch.utils import smoke

    db = os.path.join(root, "scripts.db")
    env = {"DATABASE_PATH": db, "STORAGE_ROOT": os.path.join(root, "storage"),
           "OCR_ENGINE": "hybrid", "PDF_RASTER_DPI": str(smoke.SERVICE_DPI),
           **{k.upper(): v for k, v in smoke.TRAINED.items()}}
    pdf = os.path.join(root, "form.pdf")
    with open(pdf, "wb") as f:
        f.write(smoke.scanned_pdf([np.ascontiguousarray(form[..., 0])]))
    extract = str(smoke.PACKAGE / "weights" / "extract.npz")
    dev = ["--device", str(device)]
    runs = {
        "init_db": ("db.init_db", [], r"database ready at .*\(\d+ templates seeded"),
        "db_admin_tables": ("db.db_admin", ["tables"], r"form_templates +\d+"),
        "db_admin_check": ("db.db_admin", ["check"], r"integrity_check: ok"),
        "debug_engine": ("utils.debug_engine", [pdf, *dev], r'"success": true'),
        "demo": ("utils.demo", dev, r"Extracted fields \(form type: Invoice\)"),
        "compare_extractors": ("training.compare_extractors",
                               ["--forms", "2", "--a", extract, "--b", extract, *dev],
                               r"VERDICT (ACCEPT|borderline|REJECT) "),
        "diag_forms": ("training.diag_forms", ["--pages", "1", *dev],
                       r"=== form page 0  page_cer="),
    }
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    row: dict = {"phase": "scripts", "s": {}, "lines": {}}
    failed = []
    try:
        t = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", f"{PKG}.db.init_db"], cwd=REPO,
                              capture_output=True, text=True, env={**os.environ, "PYTHONPATH": REPO})
        row["s"]["python_-m_init_db"] = time.perf_counter() - t
        if proc.returncode != 0 or "templates seeded" not in proc.stdout:
            failed.append(f"python -m init_db: {proc.returncode} {proc.stdout!r} {proc.stderr[-500:]}")
        for name, (module, argv, shape) in runs.items():
            reset_settings_cache()
            out = io.StringIO()
            t = time.perf_counter()
            code = 0
            with contextlib.redirect_stdout(out):
                try:
                    code = importlib.import_module(f"{PKG}.{module}").main(argv) or 0
                except SystemExit as e:
                    code = e.code if isinstance(e.code, int) else 1
            row["s"][name] = time.perf_counter() - t
            text = out.getvalue()
            row["lines"][name] = len(text.splitlines())
            if code != 0 or not re.search(shape, text):
                failed.append(f"{name}: exit {code}, output {text[-800:]!r}")
            if name == "debug_engine" and '"success": true' in text:
                report = json.loads(text)
                row["debug_engine_words"] = report["boxes_by_type"].get("word", 0)
                if report["total_pages"] != 1 or not report["boxes_by_type"].get("word"):
                    failed.append(f"debug_engine: {report['boxes_by_type']}")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset_settings_cache()
    row["total_s"] = sum(row["s"].values())
    if failed:
        emit({**row, "failed": failed})
        raise AssertionError("scripts: " + "; ".join(failed))
    return row


def phase_scheduler(engine, pages) -> dict:
    """Two waves through ``PageScheduler.process``: no retries, no failures."""
    from ocr_system_tpu_torch.engine.scheduler import PageScheduler

    sched = PageScheduler(engine, engine.settings)
    reset_counts()
    t = time.perf_counter()
    outs = sched.process(pages)
    sec = time.perf_counter() - t
    launched = counts()
    native = native_calls()
    st = sched.stats
    if st.retried_pages or st.failed_pages:
        raise AssertionError(f"scheduler fell back: {st}")
    words = check_outputs(outs, pages)
    if engine.recognizer.device.type == "cuda" and (
            launched["enhance"] < st.waves or launched["crop"] <= 0):
        raise AssertionError(f"kernels not on the path: {launched}")
    if native_misses(native):
        raise AssertionError("; ".join(native_misses(native)))
    return {"phase": "scheduler", "pages": len(pages), "waves": st.waves,
            "retried_pages": st.retried_pages, "failed_pages": st.failed_pages,
            "words": words, "launches": launched, "native_calls": native,
            "stage_ms": sched.timer.as_ms(), "wall_s": sec, "pages_per_s": len(pages) / sec}


# ---------------- training ----------------

# The float32 bar of the training phases: this factor times the JAX
# package's own spread (train_spread_probe.py: the range of each number over
# 9 runs that differ only in rounding). The port's deviation from the JAX
# record is the difference of two independent rounding draws, and the port
# draws from a wider distribution than XLA's variants (other elementary
# functions, other convolution algorithms): a factor of 4 allows its
# rounding noise twice XLA's at about 4 standard deviations per number
# (the range of 9 draws is ~3 of them), while a wrong BatchNorm or a
# missing term moves these numbers by far more
TRAIN_BAR_FACTOR = 4.0
# Parameter-group norms whose spread is widened to the JAX record's own
# distance from exact arithmetic (the port's float64 run of the same steps):
# the layout heads' cross-entropy gradients are p - 1 for confident tokens,
# one float32 ulp of p is a percent of that, and AdamW's first step, which
# divides each gradient by its own size, carries it into the weights. No
# variant of the probe changes how p is rounded, so the spread misses it:
# on an H100 the JAX record lies 15.7 and 10.8 times its spread from the
# float64 run on these two norms, and the port's float32 run, with only its
# cross-entropy in float64, within 0.07 and 0.02 times it (``train_cause``)
TRAIN_WIDENED = {"layout": ("type_head", "form_head")}
# The float32 run's first-step loss and gradient norm against the float64
# run's (relative): a sixteenth of TF32's unit roundoff (2^-11). The JAX
# record cannot tell TF32 from float32 in det (it lies as far from exact as
# a TF32 run does), the float64 run can: on an H100 float32 comes within
# 7.9e-6 of it (rec's loss; det's and layout's within 6e-7), while TF32
# moves the first loss 2.2e-4 (det) to 1.6e-3 (rec) from it
EXACT_BAR = 2.0 ** -15
TRAIN_MODELS = {"rec": "SVTR 192 x 6, Latin, 64 lines at W 320",
                "det": "DBNet neck 96 with its threshold head, 8 pages at 640",
                "layout": "layout transformer 512 x 8, 32 sequences at 768"}


def train_model(name: str, dtype: str, loss_dtype=None, mesh=None):
    """The model a trainer starts from, without weights, and its step
    function (det without its augmentation, as the JAX record), at compute
    ``dtype``, the batch split over ``mesh``'s dp; ``loss_dtype`` sets the
    layout heads' cross-entropy dtype."""
    import torch

    from ocr_system_tpu_torch.core.dtypes import DTypePolicy
    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.models.dbnet import DBNet
    from ocr_system_tpu_torch.models.layout_extractor import LayoutExtractor
    from ocr_system_tpu_torch.models.recognizer import SVTRRecognizer
    from ocr_system_tpu_torch.training import train as T

    policy = DTypePolicy(compute_dtype=getattr(torch, dtype))
    if name == "rec":
        model = SVTRRecognizer(get_charset("latin").size, policy=policy)
        step = T.make_rec_train_step(mesh)
    elif name == "det":
        model = DBNet(policy=policy, thresh_head=True)
        step = T.make_det_train_step(augment=False, mesh=mesh)
    else:
        model = LayoutExtractor(get_charset("multilingual").size, dim=512, depth=8)
        step = T.make_layout_train_step(policy.compute_dtype, loss_dtype, mesh)
    return model, step


def train_bar_misses(dev: dict, spread: dict) -> list[str]:
    """The numbers of a float32 run (``utils/smoke.train_deviation`` against
    the JAX record) farther from it than ``TRAIN_BAR_FACTOR`` times the JAX
    package's own spread of that number (``assets/train_spread.json``, with
    the ``TRAIN_WIDENED`` norms widened): the losses of the steps, the first
    step's gradient norm, the parameter-group norms and the BatchNorm
    statistics after the last."""
    k = TRAIN_BAR_FACTOR
    out = [f"loss step {i + 1}: {d:.3g} > {k} x {s:.3g}"
           for i, (d, s) in enumerate(zip(dev["loss"], spread["loss"])) if d > k * s]
    if dev["grad_norm"] > k * spread["grad_norm"]:
        out.append(f"grad_norm step 1: {dev['grad_norm']:.3g} > {k} x {spread['grad_norm']:.3g}")
    out += [f"norm {g}: {d:.3g} > {k} x {spread['group_norms'][g]:.3g}"
            for g, d in dev["group_norms"].items() if d > k * spread["group_norms"][g]]
    out += [f"{m}.{stat}: {d:.3g} > {k} x {spread['bn'][m][stat]:.3g}"
            for m, stats in dev.get("bn", {}).items() for stat, d in stats.items()
            if d > k * spread["bn"][m][stat]]
    return out


def exact_misses(got: dict, exact: dict) -> list[str]:
    """The first step's loss and gradient norm of a float32 run farther than
    ``EXACT_BAR`` (relative) from the float64 run's."""
    out = []
    for key in ("loss", "grad_norm"):
        d = abs(got[key][0] - exact[key][0]) / abs(exact[key][0])
        if d > EXACT_BAR:
            out.append(f"{key} step 1: {d:.3g} from float64 > {EXACT_BAR:.3g}")
    return out


def train_record(model, metrics: list[dict], want: dict) -> tuple[dict, dict]:
    """A run's numbers laid out as the JAX record's rows ``want``: per step
    the loss, the gradient norm (and tag accuracy), after the last step
    the parameter-group norms and the recorded BatchNorms' statistics; and
    the model's final state dict on the host (tp slices gathered)."""
    from ocr_system_tpu_torch.parallel.sharding import dense_state_dict
    from ocr_system_tpu_torch.training.train import group_norms

    after = {k: v.cpu() for k, v in dense_state_dict(model).items()}
    got = {"loss": [m["loss"].item() for m in metrics],
           "grad_norm": [m["grad_norm"].item() for m in metrics],
           "group_norms": group_norms(after)}
    if "tag_acc" in want:
        got["tag_acc"] = [m["tag_acc"].item() for m in metrics]
    if "bn" in want:
        got["bn"] = {b: {k: after[f"{b}.{k}"].tolist() for k in ("running_mean", "running_var")}
                     for b in want["bn"]}
    return got, after


def train_run(name: str, dtype: str, device, batch: dict, start: dict, lr: float, steps: int,
              want: dict, tf32: bool = False, loss_dtype=None,
              mesh=None) -> tuple[dict, dict, float]:
    """``steps`` steps of a trainer's step function on ``batch`` from the
    weights ``start`` at compute ``dtype`` (float64: the parameters and
    optimizer too), TF32 on or off in cuDNN and cuBLAS for the run (restored
    after), over ``mesh`` (dp; the layout model's weights placed by
    ``init_layout_state_sharded``, split over its tp): the run's record
    (``train_record``), its final state dict and its mean step ms over the
    steps after the first (CUDA events; host clock on the CPU)."""
    import torch

    from ocr_system_tpu_torch.training import train as T

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        model, step = train_model(name, dtype, loss_dtype, mesh)
        model.load_state_dict(start)
        if dtype == "float64":
            model.double()
        if name == "layout" and mesh is not None:
            state = T.init_layout_state_sharded(model, lr, mesh)
        else:
            state = T.init_state(model, lr, device)
        model.train()
        cuda = device.type == "cuda"
        metrics, marks = [], []
        for _ in range(steps):
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            else:
                marks.append(time.perf_counter())
            state, m = step(state, batch)
            metrics.append(m)
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
            torch.cuda.synchronize()
            warm_ms = marks[1].elapsed_time(marks[-1]) / (len(marks) - 2)
        else:
            marks.append(time.perf_counter())
            warm_ms = (marks[-1] - marks[1]) * 1e3 / (len(marks) - 2)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    got, after = train_record(state.model, metrics, want)
    if not (np.isfinite(got["loss"]).all() and np.isfinite(got["grad_norm"]).all()
            and all(torch.isfinite(v).all() for v in after.values())):
        raise AssertionError(f"train_{name}_{dtype}: non-finite values {got['loss']}")
    return got, after, warm_ms


def phase_train(name: str, dtype: str, device, expected: dict, bar: dict | None,
                smi: str = "", n: int | None = None, strict: dict | None = None) -> dict:
    """3 steps of a trainer's step function on its committed batch from the
    trained weights (TF32 off), held against the JAX record of the same 3
    steps (``assets/train_expected.json``). At float32 every number within
    ``TRAIN_BAR_FACTOR`` times the JAX package's own spread
    (``train_bar_misses``), and the same steps at float64 run as the exact
    reference: the first step within ``EXACT_BAR`` of it
    (``exact_misses``), and the ``TRAIN_WIDENED`` norms' spreads widened to
    the JAX record's distance from it, with the cause shown in the same
    run: the float32 run with its cross-entropy in float64 within the
    unwidened bar of the float64 run there. At bf16 reported, against the
    JAX bf16 record and ``strict`` (the JAX bf16 record with every
    operation rounded, train_spread_probe.py --bf16). The start weights and
    batch must be those the record was computed from (digests). Prints the
    losses, the step ms (CUDA events, steps 2 and 3) and the peak device
    memory. ``n`` cuts the batch to its first n samples and skips the
    record (the CPU tests)."""
    import torch

    from ocr_system_tpu_torch.training import train as T
    from ocr_system_tpu_torch.utils import smoke

    device = torch.device(device)
    want = expected[dtype][name]
    batch = smoke.train_batches()[name]
    start = smoke.train_start(name)
    inputs = {"batch": smoke.digest(batch), "start": smoke.digest(start)}
    if inputs != expected["inputs"][name]:
        raise AssertionError(f"{name}: the committed batch or weights are not the record's")
    if n is not None:
        batch = {k: v[:n] for k, v in batch.items()}
    batch = T.to_device(batch, device)
    lr, steps = expected["lr"][name], expected["steps"]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    got, _, warm_ms = train_run(name, dtype, device, batch, start, lr, steps, want)
    row = {"phase": f"train_{name}_{dtype}", "model": TRAIN_MODELS[name],
           "batch": {k: list(v.shape) for k, v in batch.items() if hasattr(v, "shape")},
           "loss": got["loss"], "jax_loss": want["loss"], "grad_norm": got["grad_norm"],
           "jax_grad_norm": want["grad_norm"]}
    if "tag_acc" in got:
        row.update(tag_acc=got["tag_acc"], jax_tag_acc=want["tag_acc"])
    if cuda:
        row.update(step_ms=warm_ms, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   nvidia_smi=smi)
    else:
        row["host_step_ms"] = warm_ms
    if n is not None:
        return row
    dev = smoke.train_deviation(got, want)
    row["deviation"] = dev
    if dtype != "float32":
        row["jax_strict_loss"] = strict[name]["loss"]
        row["deviation_strict"] = smoke.train_deviation(got, strict[name])
        return row
    exact, _, _ = train_run(name, "float64", device, batch, start, lr, steps, want)
    row["exact"] = {k: exact[k] for k in ("loss", "grad_norm")}
    row["exact_misses"] = exact_misses(got, exact)
    spread = copy.deepcopy(bar[name])
    if name in TRAIN_WIDENED:
        cause, _, _ = train_run(name, "float32", device, batch, start, lr, steps, want,
                                loss_dtype=torch.float64)
        row["train_cause"] = {}
        for g in TRAIN_WIDENED[name]:
            exact_g = exact["group_norms"][g]
            jax_off, off, ce_off = (abs(r["group_norms"][g] - exact_g) / exact_g
                                    for r in (want, got, cause))
            row["train_cause"][g] = {"spread": spread["group_norms"][g], "jax_vs_float64": jax_off,
                                     "float32_vs_float64": off,
                                     "float32_ce_float64_vs_float64": ce_off}
            if ce_off > TRAIN_BAR_FACTOR * spread["group_norms"][g]:
                raise AssertionError(f"train_{name}_float32: with its cross-entropy in float64 "
                                     f"the {g} norm is still {ce_off:.3g} from float64")
            spread["group_norms"][g] = max(spread["group_norms"][g], jax_off)
    row.update(spread=spread, bar_factor=TRAIN_BAR_FACTOR,
               bar_misses=train_bar_misses(dev, spread))
    if row["bar_misses"] or row["exact_misses"]:
        raise AssertionError(f"train_{name}_float32 outside its bar: {json.dumps(row)}")
    return row


def phase_train_tf32_control(name: str, device, expected: dict, exact: dict) -> dict:
    """The negative control of a float32 training phase: the same steps with
    TF32 on in cuDNN and cuBLAS (10 mantissa bits in every product) must
    miss the phase's exact bar against its float64 run (``exact``, the
    phase's row); a control that passes means the bar cannot tell TF32 from
    float32, and fails the phase. Its JAX deviation is reported."""
    import torch

    from ocr_system_tpu_torch.training import train as T
    from ocr_system_tpu_torch.utils import smoke

    device = torch.device(device)
    want = expected["float32"][name]
    batch = T.to_device(smoke.train_batches()[name], device)
    got, _, _ = train_run(name, "float32", device, batch, smoke.train_start(name),
                          expected["lr"][name], expected["steps"], want, tf32=True)
    misses = exact_misses(got, exact)
    row = {"phase": f"train_{name}_float32_tf32_control", "loss": got["loss"],
           "exact": exact, "exact_misses": misses, "correct": not misses,
           "deviation": smoke.train_deviation(got, want)}
    if not misses:
        raise AssertionError(f"train_{name}: TF32 passed the exact bar: {json.dumps(row)}")
    return row


def phase_train_layout_cli(device, steps: int = 20, batch_size: int = 32, max_len: int = 768,
                           dim: int = 512, depth: int = 8, smi: str = "") -> dict:
    """``train_layout`` end to end at bf16 through its own iterator (the
    PIL-free form generator) from a from-scratch init: its first and last
    losses. On the card then twice more from where it ended, each time
    ``steps`` steps on the same stream: unprofiled, for steps/s (warm:
    cuBLAS and the allocator set up by the first run), and under
    torch.profiler with CUDA activity only, for the device's idle share
    (the union of the kernel intervals against the run's wall time) -
    whether the generator or the card sets the pace."""
    import torch

    from ocr_system_tpu_torch.core.dtypes import DTypePolicy
    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.models.layout_extractor import LayoutExtractor
    from ocr_system_tpu_torch.training import train as T

    device = torch.device(device)
    model = LayoutExtractor(get_charset("multilingual").size, dim=dim, depth=depth)
    state = T.init_state(model, 3e-4, device, torch.Generator().manual_seed(SEED))
    kw = dict(steps=steps, batch_size=batch_size, max_len=max_len, dim=dim, depth=depth,
              policy=DTypePolicy(compute_dtype=torch.bfloat16), log_every=0, seed=SEED,
              device=device)
    row = {"phase": "train_layout_cli", "model": f"layout {dim} x {depth}, bf16",
           "steps": steps, "batch": [batch_size, max_len]}
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def timed():
        t = time.perf_counter()
        _, metrics = T.train_layout(state=state, **kw)
        if cuda:
            torch.cuda.synchronize()
        return metrics, (time.perf_counter() - t) * 1e3

    metrics, first_ms = timed()
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"train_layout_cli: non-finite metrics {metrics}")
    row.update(metrics)
    if not cuda:
        return {**row, "host_steps_per_s": steps / first_ms * 1e3}
    from ocr_system_tpu_torch.utils.profile_wave import device_busy_ms

    _, warm_ms = timed()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, prof_ms = timed()
    busy = device_busy_ms(prof)
    return {**row, "first_run_steps_per_s": steps / first_ms * 1e3,
            "steps_per_s": steps / warm_ms * 1e3, "warm_wall_ms": warm_ms,
            "profiled_wall_ms": prof_ms, "device_busy_ms": busy,
            "device_idle_share": None if busy is None else 1.0 - busy / prof_ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "nvidia_smi": smi}


def phase_train_cli(name: str, device, steps: int = 10, batch: int | None = None,
                    size: int | None = None, smi: str = "") -> dict:
    """The rec or det trainer at the train_models CLI's batch (rec: 64
    lines at W 320; det: 8 pages at 640) at bf16 from a from-scratch init,
    on its own rendering iterator (the fonts come with the package): its
    first and last losses over ``steps`` steps; on the card then ``steps``
    more unprofiled (steps/s, warm) and ``steps`` more under a CUDA-only
    profile (the device's idle share), as ``phase_train_layout_cli``. The
    det iterator's pool is the batch (8 pages, rendered before the first
    step; the CLI keeps 64), refreshed by its two workers."""
    import torch

    from ocr_system_tpu_torch.core.dtypes import DTypePolicy
    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.training import train as T

    device = torch.device(device)
    policy = DTypePolicy(compute_dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(SEED)
    if name == "rec":
        from ocr_system_tpu_torch.models.recognizer import SVTRRecognizer

        charset, batch, size = get_charset("latin"), batch or 64, size or 320
        state = T.init_state(SVTRRecognizer(vocab_size=charset.size, policy=policy), 1e-3,
                             device, gen)
        step = T.make_rec_train_step()
        it = T.rec_batch_iterator(charset, batch, width=size, seed=SEED)
        shape = [batch, 48, size]
    else:
        from ocr_system_tpu_torch.models.dbnet import DBNet

        batch, size = batch or 8, size or 640
        state = T.init_state(DBNet(policy=policy, thresh_head=True), 1e-3, device, gen)
        step = T.make_det_train_step()
        it = T.det_batch_iterator(batch, size=size, seed=SEED, pool_size=batch)
        shape = [batch, size, size]
    cuda = device.type == "cuda"
    row = {"phase": f"train_{name}_cli", "model": {"rec": "SVTR 192 x 6, Latin",
                                                  "det": "DBNet, neck 96"}[name] + ", bf16",
           "steps": steps, "batch": shape}

    def timed():
        t0 = time.perf_counter()
        seen = T._run(name, state, step, it, steps, 0)
        if cuda:
            torch.cuda.synchronize()
        return [v.item() for v in seen["loss"]], (time.perf_counter() - t0) * 1e3

    try:
        t = time.perf_counter()
        first = next(it)  # the iterator's set-up: its pool rendered
        row["iterator_setup_s"] = time.perf_counter() - t
        it = _prepend(first, it)
        losses, first_ms = timed()
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train_{name}_cli: non-finite losses {losses}")
        row.update(loss_first=losses[0], loss_last=losses[-1])
        if not cuda:
            return {**row, "host_steps_per_s": steps / first_ms * 1e3}
        from ocr_system_tpu_torch.utils.profile_wave import device_busy_ms

        _, warm_ms = timed()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            _, prof_ms = timed()
    finally:
        if hasattr(it, "close"):
            it.close()  # stops the det iterator's page workers
    busy = device_busy_ms(prof)
    return {**row, "first_run_steps_per_s": steps / first_ms * 1e3,
            "steps_per_s": steps / warm_ms * 1e3, "warm_wall_ms": warm_ms,
            "profiled_wall_ms": prof_ms, "device_busy_ms": busy,
            "device_idle_share": None if busy is None else 1.0 - busy / prof_ms,
            "nvidia_smi": smi}


def _prepend(first, it):
    """``first``, then the rest of ``it``; closing it closes ``it``."""
    try:
        yield first
        yield from it
    finally:
        it.close()


# ---- quality evaluation ----

# the kernels each eval phase must launch on the card (every other kernel:
# none): crop wherever a recognizer reads lines or pages, enhance wherever
# DBNet detects at the default settings (the classical engine has no DBNet)
EVAL_LAUNCHES = {
    "eval_rec": ("crop",),
    "eval_e2e_hybrid": ("enhance", "crop"),
    "eval_e2e_classical": ("crop",),
    "eval_e2e_hindi": ("enhance", "crop"),
    "eval_extract": (),
    "eval_forms_e2e": ("enhance", "crop"),
    "eval_signatures": ("enhance", "crop"),
}


# the kernels whose launches a phase gates; rotate launches where a page
# is found skewed, which the data decides
GATED = ("enhance", "crop")


def launch_misses(launched: dict, want: tuple[str, ...], on_card: bool) -> list[str]:
    """Kernels that launched where they must not, or did not where they
    must (on the card only: on the CPU the wrappers count nothing)."""
    if not on_card:
        return []
    return [f"{k} launched {v} times" for k, v in launched.items()
            if k in GATED and (v > 0) != (k in want)]


def phase_fonts(want: dict) -> dict:
    """The renderer's fonts on this machine: PIL, its FreeType and whether
    its complex text layout (raqm) is there, whether fontTools is there (it
    need not be), where each font came from, and whether the first
    held-out Latin and Devanagari lines render the JAX record's pixels
    (reported: without raqm PIL lays text out glyph by glyph, and the
    eval phases replay the record's renders)."""
    import importlib.util

    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.training import synth
    from ocr_system_tpu_torch.utils.smoke import pixels_digest

    from PIL import __version__ as pil, features

    fonts = synth.discover_fonts()
    equal = {}
    for cs in ("latin", "devanagari"):
        line = synth.TextRenderer(get_charset(cs), seed=9999).render_line(
            max_width=320, augment=False)
        digest = pixels_digest((line.image * 255).astype(np.uint8))
        equal[cs] = digest == want["phases"]["eval_rec"]["float32"][cs]["digests"][0]
    row = {"phase": "fonts", "pil": pil, "freetype2": features.check("freetype2"),
           "freetype_version": features.version("freetype2"),
           "raqm": features.check("raqm"),
           "fonttools": importlib.util.find_spec("fontTools") is not None,
           "fonts": [os.path.relpath(f, REPO) if str(f).startswith(REPO) else str(f)
                     for f in fonts],
           "first_line_pixels_equal_record": equal}
    missing = [str(f) for f in fonts if not os.path.isfile(f)]
    if missing or not row["freetype2"]:
        emit({**row, "failed": missing})
        raise AssertionError(f"fonts: missing {missing} or no FreeType")
    return row


class CerClock:
    """Times the evaluation's edit-distance work (``edit_distance``, which
    ``cer`` calls, and ``infix_cer``) while it is entered."""

    def __enter__(self):
        from ocr_system_tpu_torch.training import evaluate as E

        self.seconds = 0.0
        self.saved = {k: getattr(E, k) for k in ("edit_distance", "infix_cer")}

        def timed(fn):
            def call(*args):
                t = time.perf_counter()
                try:
                    return fn(*args)
                finally:
                    self.seconds += time.perf_counter() - t
            return call

        for k, fn in self.saved.items():
            setattr(E, k, timed(fn))
        return self

    def __exit__(self, *exc):
        from ocr_system_tpu_torch.training import evaluate as E

        for k, fn in self.saved.items():
            setattr(E, k, fn)


def phase_eval(name: str, kits: dict, want: dict, renders: tuple | None = None,
               sizes: dict | None = None) -> dict:
    """One eval phase (utils/smoke.EVAL_PHASES) at each dtype of ``kits``
    against the JAX record ``want`` (by dtype): float32 gated
    (utils/smoke.compare_eval: the exact bar where every digest is the
    record's, the quality bar where not), bf16 reported; the launches of
    each run must be those of EVAL_LAUNCHES. With ``renders`` (the
    record's render events of this phase and the arrays), the renderers
    replay the lines and pages the JAX package drew instead of drawing
    (utils/smoke.ReplayedRenders): this machine's PIL lays text out
    otherwise (phase fonts). Prints the seconds of each run and the share
    of them spent in edit distances."""
    import contextlib

    from ocr_system_tpu_torch.utils import smoke

    row: dict = {"phase": name, "renders": "replayed" if renders else "drawn here"}
    failed: list[str] = []
    for dtype, kit in kits.items():
        reset_counts()
        t = time.perf_counter()
        replay = smoke.ReplayedRenders(*renders) if renders else contextlib.nullcontext()
        with CerClock() as clock, replay:
            runs = smoke.run_eval(name, kit, **({"sizes": sizes} if sizes else {}))
        sec = time.perf_counter() - t
        launched = counts()
        cmp = smoke.compare_eval(want[dtype], runs, gate=dtype == "float32")
        on_card = kit["rec"]["latin"].device.type == "cuda"
        misses = cmp["misses"] + launch_misses(launched, EVAL_LAUNCHES[name], on_card)
        row[dtype] = {"s": sec, "cer_s": clock.seconds, "cer_share": clock.seconds / sec,
                      "launches": launched, "runs": cmp["runs"], "misses": misses}
        failed += [f"{dtype} {m}" for m in misses]
    if failed:
        emit({**row, "failed": failed})
        raise AssertionError(f"{name}: " + "; ".join(failed))
    return row


def phase_det_settings(device, forms, base: dict, record: dict, smi: str = "") -> dict:
    """The served hybrid engine at float32 on ``forms`` at each detector
    setting of utils/smoke.DET_SETTINGS, against the JAX engine's record:
    words matched (IoU >= 0.9, the same text) on at least the waves' 98%,
    each page's word count equal; enhance must launch except where the JAX
    detector runs no Pallas kernel (contrast off, binarization on), crop
    always. Prints each setting's wave ms and launches."""
    from ocr_system_tpu_torch.engine.preprocess import PageImage
    from ocr_system_tpu_torch.utils import smoke

    pages = [PageImage(np.ascontiguousarray(p), i + 1) for i, p in enumerate(forms)]
    row: dict = {"phase": "det_settings", "pages": len(pages), "settings": {},
                 "nvidia_smi": smi}
    failed = []
    for name, update in smoke.DET_SETTINGS.items():
        engine = smoke.build_engine(device, **base, compute_dtype="float32", **update)
        reset_counts()
        t = time.perf_counter()
        outs = engine.process_pages(pages)
        ms = (time.perf_counter() - t) * 1e3
        launched = counts()
        native = native_calls()
        check_outputs(outs, pages)
        got = [smoke.det_settings_record(o) for o in outs]
        per = [smoke.compare_to_expected(e, g) for e, g in zip(record[name], got, strict=True)]
        n = sum(c["words"] for c in per)
        matched = sum(c["matched"] for c in per)
        counts_equal = [len(e["word"]) == len(g["word"]) for e, g in zip(record[name], got)]
        want = ("crop",) if name in smoke.DET_SETTINGS_PLAIN else ("enhance", "crop")
        on_card = engine.recognizer.device.type == "cuda"
        misses = launch_misses(launched, want, on_card)
        # the probability-map box path serves every prob wire width
        analyzed = ("cc_analyze_u8",) if update.get("det_prob_wire_bits") else ()
        misses += native_misses(native, NATIVE_ON_WAVE + analyzed)
        if matched < 0.98 * n:
            misses.append(f"{matched} of {n} words matched, under 0.98")
        if not all(counts_equal):
            misses.append(f"word counts differ: {[len(g['word']) for g in got]} against "
                          f"{[len(e['word']) for e in record[name]]}")
        row["settings"][name] = {"update": update, "wave_ms": ms, "launches": launched,
                                 "native_calls": native,
                                 "words_expected": n, "words_matched": matched,
                                 "word_counts": [len(g["word"]) for g in got],
                                 "stage_ms": dict(engine.stage_ms), "misses": misses}
        failed += [f"{name}: {m}" for m in misses]
    if failed:
        emit({**row, "failed": failed})
        raise AssertionError("det_settings: " + "; ".join(failed))
    return row


# ---------------- the parallel layer (core/mesh.py, parallel/) ----------------

VIRTUAL = 4  # the virtual mesh's ways: one card named VIRTUAL times


def virtual_mesh(spec: str, device, n: int = VIRTUAL):
    """``spec`` over ``device`` named ``n`` times: a virtual mesh, whose
    times measure the schedule on one card, not multi-card speed."""
    from ocr_system_tpu_torch.core.mesh import build_mesh

    return build_mesh(spec, [device] * n)


def mesh_row(mesh) -> dict:
    return {"shape": mesh.shape, "devices": mesh.size,
            "distinct_devices": len(mesh.distinct_devices()),
            "virtual": len(mesh.distinct_devices()) < mesh.size}


def phase_dp_wave(device, pages, expected: list[dict], settings: dict, default_mesh,
                  smi: str = "", min_text: float = 1.0) -> dict:
    """The served engine (``settings``) on one wave, first under the
    default mesh (dp=1 on a one-card machine: unsharded), then under a
    virtual dp=``VIRTUAL`` mesh with its pages split over the dp devices, a
    new engine for each (an engine resolves its mesh at its first wave).
    Gates: each wave's words against the JAX record (``phase_hybrid`` at
    ``min_text``, recognizers and rescue counts equal), the dp wave's
    records equal to the dp=1 wave's, its det canvases split, and on the
    card the enhance and crop kernels launched on every dp shard."""
    import torch

    from ocr_system_tpu_torch.core.mesh import DATA_AXIS, ShardedBatch, mesh_context
    from ocr_system_tpu_torch.kernels import crop, enhance
    from ocr_system_tpu_torch.utils import smoke

    rows, records = {}, {}
    for tag, mesh in (("dp1", default_mesh), (f"dp{VIRTUAL}", virtual_mesh("dp=-1", device))):
        engine = smoke.new_engine(device, **settings)
        records[tag] = []
        with mesh_context(mesh):
            engine.process_pages(pages[:1])  # first call: cuDNN/cuBLAS set-up
            rows[tag] = phase_hybrid(engine, pages, expected, min_text, min_text,
                                     f"multichip_{tag}", routing_equal=True,
                                     records_out=records[tag])
            split = engine.detector.neural._mesh() if hasattr(engine.detector, "neural") \
                else engine.detector._mesh()
        rows[tag]["mesh"] = mesh_row(mesh)
        rows[tag]["split_over_dp"] = split is not None
    shards = {"enhance": dict(enhance.LAUNCHES.by_shard), "crop": dict(crop.LAUNCHES.by_shard)}
    dp = f"dp{VIRTUAL}"
    row = {"phase": "multichip_dp_wave", "pages": len(pages),
           "pages_per_dp_shard": len(pages) / VIRTUAL,
           "words": {k: r["words"] for k, r in rows.items()},
           "words_matched": {k: r["words_matched"] for k, r in rows.items()},
           "words_expected": rows["dp1"]["words_expected"],
           "records_equal": records["dp1"] == records[dp],
           "meshes": {k: r["mesh"] for k, r in rows.items()},
           "wave_ms": {k: r["wall_s"] * 1e3 for k, r in rows.items()},
           "launches": {k: r["launches"] for k, r in rows.items()},
           "launches_per_shard": shards, "stage_ms": {k: r["stage_ms"] for k, r in rows.items()},
           "timing_note": "the dp wave runs its shards one after another on one card",
           "nvidia_smi": smi}
    failed = []
    if rows["dp1"]["split_over_dp"] or not rows[dp]["split_over_dp"]:
        failed.append(f"split over dp: {rows['dp1']['split_over_dp']} / "
                      f"{rows[dp]['split_over_dp']}")
    if not row["records_equal"]:
        failed.append("the dp wave's pages differ from the dp=1 wave's")
    if torch.device(device).type == "cuda" and any(
            shards[k].get(i, 0) < 1 for k in shards for i in range(VIRTUAL)):
        failed.append(f"a kernel missed a dp shard: {shards}")
    if failed:
        emit({**row, "failed": failed})
        raise AssertionError("multichip_dp_wave: " + "; ".join(failed))
    return row


def phase_sp_extract(device, docs: dict, expected: dict, smi: str = "",
                     buckets=(512, 1024, 2048), logits_at: int = 2048) -> dict:
    """The trained 512 x 8 extractor through ``get_extractor`` under a
    virtual sp=``VIRTUAL`` mesh (``LayoutModelExtractor`` turns ring
    attention on from it) at float32: every document's fields equal to the
    JAX record (``phase_extract``, exact), and at ``logits_at`` seeded
    tokens every output of the ring forward within 1e-4 of its largest
    value of the dense forward's (the same weights, no mesh). Forward ms
    of both at ``buckets`` (one card: the ring's blocks run in turn)."""
    import torch

    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.core.mesh import mesh_context
    from ocr_system_tpu_torch.extract.layout_model import get_extractor
    from ocr_system_tpu_torch.models.layout_extractor import COORD_BUCKETS

    s = Settings(compute_dtype="float32")
    mesh = virtual_mesh("dp=1,tp=1,sp=-1", device)
    dense = get_extractor(s, device=device)
    with mesh_context(mesh):
        ring = get_extractor(s, device=device)
        if not (ring.model.sequence_parallel and not dense.model.sequence_parallel):
            raise AssertionError("multichip_sp_extract: sequence parallelism not from the mesh")
        row = phase_extract(ring, docs, expected, "multichip_sp_extract", True, smi=smi,
                            buckets=buckets)
        rng = np.random.default_rng(SEED + 5)
        ids = torch.from_numpy(rng.integers(1, ring.charset.size, (1, logits_at))).to(device)
        boxes = torch.from_numpy(np.sort(rng.integers(0, COORD_BUCKETS, (1, logits_at, 4)), -1))
        mask = torch.ones((1, logits_at), dtype=torch.long, device=device)
        mask[:, logits_at - logits_at // 5:] = 0  # a padded tail
        with torch.inference_mode():
            got = ring.model(ids, boxes.to(device), mask, ring.dtype)
    with torch.inference_mode():
        want = dense.model(ids, boxes.to(device), mask, dense.dtype)
    valid = mask[0].bool()

    def tokens(t):  # the valid tokens of a per-token output
        return t[:, valid] if t.shape[1] == logits_at else t

    rel = {k: ((tokens(got[k]) - tokens(w)).abs().max()
               / tokens(w).abs().max().clamp_min(1e-30)).item() for k, w in want.items()}
    row.update(phase="multichip_sp_extract", mesh=mesh_row(mesh), logits_tokens=logits_at,
               logits_rel_diff=rel, forward_ring=row.pop("forward"),
               forward_dense=time_forward(dense, buckets),
               timing_note="the ring's blocks run one after another on one card")
    if max(rel.values()) > 1e-4:
        emit({**row, "failed": "ring vs dense"})
        raise AssertionError(f"multichip_sp_extract: ring vs dense outputs {rel}")
    return row


def phase_train_mesh(name: str, device, expected: dict, bar: dict | None, mesh,
                     smi: str = "", n: int | None = None) -> dict:
    """3 float32 steps of a trainer over ``mesh`` (its dp, and tp for the
    layout model) on the committed batch from the trained weights, and the
    same steps on one device: the mesh run's losses, gradient norm and
    parameter-group norms against the JAX record within ``bar`` (the
    spread ``phase_train`` held the one-device run to, its widened norms
    included), and its BatchNorm running statistics against the one-device
    run's within the same bar. ``n`` cuts the batch (the CPU tests) and
    skips the bars."""
    import torch

    from ocr_system_tpu_torch.training import train as T
    from ocr_system_tpu_torch.utils import smoke

    device = torch.device(device)
    want = expected["float32"][name]
    batch = smoke.train_batches()[name]
    if n is not None:
        batch = {k: v[:n] for k, v in batch.items()}
    batch = T.to_device(batch, device)
    start = smoke.train_start(name)
    lr, steps = expected["lr"][name], expected["steps"]
    one, _, one_ms = train_run(name, "float32", device, batch, start, lr, steps, want)
    got, _, ms = train_run(name, "float32", device, batch, start, lr, steps, want, mesh=mesh)
    row = {"phase": f"multichip_train_{name}", "model": TRAIN_MODELS[name],
           "mesh": mesh_row(mesh), "loss": got["loss"], "one_device_loss": one["loss"],
           "jax_loss": want["loss"], "grad_norm": got["grad_norm"],
           "step_ms" if device.type == "cuda" else "host_step_ms": ms,
           "one_device_step_ms": one_ms,
           "timing_note": "the shards run in lockstep threads on one card", "nvidia_smi": smi}
    if n is not None:
        return row
    dev, vs_one = smoke.train_deviation(got, want), smoke.train_deviation(got, one)
    misses = train_bar_misses(dev, bar)
    misses += [f"vs one device: {m}" for m in train_bar_misses(
        {"loss": [], "grad_norm": 0.0, "group_norms": {}, "bn": vs_one.get("bn", {})}, bar)]
    row.update(deviation=dev, vs_one_device=vs_one, bar_factor=TRAIN_BAR_FACTOR,
               bar_misses=misses)
    if misses:
        raise AssertionError(f"multichip_train_{name} outside its bar: {json.dumps(row)}")
    return row


def phase_gpipe(device, smi: str = "", n_micro: int = 8, mb: int = 2, tokens: int = 256,
                depth: int | None = None) -> dict:
    """The trained 512 x 8 extractor's blocks as pp=``VIRTUAL`` GPipe
    stages (2 blocks each) on a virtual mesh, ``n_micro`` microbatches of
    ``mb`` x ``tokens`` seeded activations, float32 (TF32 off): the output
    and the gradient of a squared-error loss for every stage parameter
    through the schedule against ``serial_reference`` (forward within 1e-5
    and gradients within 1e-4 of their largest value), and the ms of
    forward and backward of both (one card: the stages run in turn)."""
    import torch

    from ocr_system_tpu_torch.core.weights import load_npz
    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.models.layout_extractor import LayoutExtractor
    from ocr_system_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        serial_reference,
        stack_stage_params,
    )
    from ocr_system_tpu_torch.utils import smoke

    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        model = LayoutExtractor(get_charset("multilingual").size, dim=512, depth=8)
        model.load_state_dict({k: v.float() for k, v in
                               load_npz(smoke.PACKAGE / "weights" / "extract.npz").items()})
        blocks = list(model.blocks)[:depth]
        mesh = virtual_mesh("pp=-1", device)
        per = len(blocks) // VIRTUAL
        stages = [{f"{j}.{k}": v.detach().to(device) for j in range(per)
                   for k, v in blocks[d * per + j].state_dict().items()} for d in range(VIRTUAL)]
        template = blocks[0].to(device)
        width = template.norm1.weight.numel()

        def stage_fn(p, x):
            shape = x.shape
            h = x.reshape(-1, shape[-2], shape[-1])
            bias = torch.zeros(h.shape[0], 1, 1, h.shape[1], device=h.device)
            valid = torch.ones(h.shape[:2], dtype=torch.bool, device=h.device)
            for j in range(per):
                w = {k.split(".", 1)[1]: v for k, v in p.items() if k.startswith(f"{j}.")}
                h = torch.func.functional_call(template, w, (h, bias, valid))
            return h.reshape(shape)

        g = torch.Generator().manual_seed(SEED + 6)
        x = torch.randn(n_micro, mb, tokens, width, generator=g).to(device)
        tgt = torch.randn(n_micro, mb, tokens, width, generator=g).to(device)
        stacked = {k: v.requires_grad_() for k, v in stack_stage_params(stages).items()}
        for s in stages:
            for v in s.values():
                v.requires_grad_()
        timed = {}
        cuda = torch.device(device).type == "cuda"

        def run(name, fn, leaves):
            """fn's forward and backward, twice: the second run is timed
            (host clock around a synchronised run)."""
            for _ in range(2):
                for v in leaves:
                    v.grad = None
                if cuda:
                    torch.cuda.synchronize()
                t = time.perf_counter()
                out = fn()
                ((out - tgt) ** 2).mean().backward()
                if cuda:
                    torch.cuda.synchronize()
            timed[name] = (time.perf_counter() - t) * 1e3
            return out.detach()

        out = run("pipeline", lambda: pipeline_apply(stage_fn, stacked, x, mesh),
                  list(stacked.values()))
        ref = run("serial", lambda: serial_reference(stage_fn, stages, x),
                  [v for s in stages for v in s.values()])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    fwd = ((out - ref).abs().max() / ref.abs().max()).item()
    grad = {k: ((stacked[k].grad - torch.stack([s[k].grad for s in stages])).abs().max()
                / torch.stack([s[k].grad for s in stages]).abs().max().clamp_min(1e-30)).item()
            for k in stacked}
    row = {"phase": "multichip_gpipe", "mesh": mesh_row(mesh), "stages": VIRTUAL,
           "blocks_per_stage": per, "microbatches": n_micro, "microbatch": [mb, tokens, width],
           "ticks": n_micro + VIRTUAL - 1, "forward_rel_diff": fwd,
           "grad_rel_diff_max": max(grad.values()), "fwd_bwd_ms": timed,
           "timing_note": "host clock, after a warm-up; the stages run one after another "
                          "on one card",
           "nvidia_smi": smi}
    if fwd > 1e-5 or max(grad.values()) > 1e-4:
        emit({**row, "failed": "pipeline vs serial", "grad_rel_diff": grad})
        raise AssertionError(f"multichip_gpipe: forward {fwd}, gradients {grad}")
    return row


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


def bound(nbytes: float, flops: float, peak_flops: float = H100_F32_FLOPS) -> dict:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
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


# float64 operations a pixel of the rotate kernel for C channels: the
# coordinates 8, the fractions 2, two weight sets 21 each, 16 weight
# products, and a multiply and an add per channel and tap
def rotate_flops_per_px(c: int) -> int:
    return 8 + 2 + 2 * 21 + 16 + 16 * 2 * c


def kernel_rotate(dev, flush, forms) -> dict:
    """The rotate kernel at the served shape: the 8 committed forms (RGB,
    960 x 960) in one launch, each at its own angle in the forms cell's
    +-4 degrees, white outside, bit for bit rotate_cubic's (its plain
    version, on the host), gray too. Times the kernel cold and warm (CUDA
    events), the plain version (host clock, one pass over the 8 pages) and
    the turn as the detector pays it (``turn_pages``: the pages up, the
    launch, the pages back; host clock)."""
    import torch

    from ocr_system_tpu_torch.engine.detector import turn_pages
    from ocr_system_tpu_torch.kernels import rotate

    rng = np.random.default_rng(SEED + 5)
    angles = [float(a) for a in rng.choice([-1, 1], 8) * rng.uniform(0.5, 4.0, 8)]
    forms = np.ascontiguousarray(forms)
    b, h, w, c = forms.shape
    pages = torch.from_numpy(forms).to(dev)
    t = time.perf_counter()
    want = rotate.rotate_pages_plain(torch.from_numpy(forms), angles)
    plain_ms = (time.perf_counter() - t) * 1e3
    reset_counts()
    got = rotate.rotate_pages(pages, angles).cpu()
    if rotate.LAUNCHES.value != 1 or not torch.equal(got, want):
        raise AssertionError(f"rotate: launches {rotate.LAUNCHES.value}, "
                             f"{int((got != want).sum())} bytes off rotate_cubic")
    gray = np.ascontiguousarray(forms[..., :1])
    gray_want = rotate.rotate_pages_plain(torch.from_numpy(gray), angles)
    if not torch.equal(rotate.rotate_pages(torch.from_numpy(gray).to(dev), angles).cpu(),
                       gray_want):
        raise AssertionError("rotate: the gray form is not rotate_cubic's")
    call = lambda: rotate.rotate_pages(pages, angles)  # noqa: E731
    row = {"form": f"{b} x {h}x{w}x{c} u8, +-4 deg", "bit_exact": True,
           "ms": cold_ms(call, flush), "warm_ms": cuda_ms(call), "plain_ms": plain_ms,
           "plain_device": "host", "library_ms": None, "shape": [b, h, w, c],
           "angles": angles}
    listed = list(forms)
    turn_pages(listed, angles, dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(5):
        turn_pages(listed, angles, dev)
    row["turn_ms"] = (time.perf_counter() - t) * 1e3 / 5
    row.update(bound(2 * pages.numel(), b * h * w * rotate_flops_per_px(c), H100_F64_FLOPS))
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return {"name": "rotate", **row}


# float32 operations a pixel of the ink mask's Gaussian, an FMA counted as
# two: a multiply and 30 FMAs a row, a multiply, 15 adds and 15 FMAs a column
INK_MASK_FLOPS_PER_PX = 1 + 2 * 30 + 1 + 15 + 2 * 15


def kernel_ink_mask(dev, flush, forms) -> dict:
    """The ink-mask kernel at the served shape: each of the 8 committed
    forms (RGB, 960 x 960) in a launch of its own, bit for bit its plain
    version and the host mask (``classical_detector._ink_mask``). Times the
    kernel cold and warm on one page (CUDA events), the plain version and
    the host mask (host clock, a page each), and the mask as the detector
    pays it (``_ink_mask_on_card``: the page up, the launch, the mask back;
    host clock)."""
    import torch

    from ocr_system_tpu_torch.engine import classical_detector
    from ocr_system_tpu_torch.kernels import ink_mask

    forms = np.ascontiguousarray(forms)
    b, h, w, c = forms.shape
    plain_s = host_s = 0.0
    reset_counts()
    for k, form in enumerate(forms):
        t = time.perf_counter()
        want = ink_mask.ink_mask_pages_plain(torch.from_numpy(form))
        t1 = time.perf_counter()
        host = classical_detector._ink_mask(form)
        plain_s, host_s = plain_s + t1 - t, host_s + time.perf_counter() - t1
        got = ink_mask.ink_mask_pages(torch.from_numpy(form).to(dev)).cpu()
        if not torch.equal(got, want) or not np.array_equal(got.numpy(), host):
            raise AssertionError(f"ink_mask: form {k}: {int((got != want).sum())} pixels off "
                                 f"the plain version, {int((got.numpy() != host).sum())} off "
                                 "the host mask")
    if ink_mask.LAUNCHES.value != b:
        raise AssertionError(f"ink_mask: {ink_mask.LAUNCHES.value} launches for {b} pages")
    page = torch.from_numpy(forms[0]).to(dev)
    call = lambda: ink_mask.ink_mask_pages(page)  # noqa: E731
    row = {"form": f"{h}x{w}x{c} u8 -> {h}x{w} u8, one page", "bit_exact": True,
           "pages": b, "ms": cold_ms(call, flush), "warm_ms": cuda_ms(call),
           "plain_ms": plain_s * 1e3 / b, "plain_device": "host",
           "host_mask_ms": host_s * 1e3 / b, "library_ms": None, "shape": [h, w, c]}
    classical_detector._ink_mask_on_card(forms[0], dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for form in forms:
        classical_detector._ink_mask_on_card(form, dev)
    row["mask_ms"] = (time.perf_counter() - t) * 1e3 / b
    row.update(bound(page.numel() + h * w, h * w * INK_MASK_FLOPS_PER_PX))
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    return {"name": "ink_mask", **row}


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

    from ocr_system_tpu_torch.engine.host_image import rotate_cubic
    from ocr_system_tpu_torch.engine.preprocess import PageImage
    from ocr_system_tpu_torch.utils import smoke

    k_rot = kernel_rotate(dev, flush, smoke.smoke_forms()[0])
    k_ink = kernel_ink_mask(dev, flush, smoke.smoke_forms()[0])
    del flush
    emit({"phase": "kernels", "enhance": k_enh, "crop": k_crop, "rotate": k_rot,
          "ink_mask": k_ink,
          "elapsed_s": time.perf_counter() - t})

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

    # ---- phase 2b: the native host library, each op against its plain
    # version on the 12 committed forms' served inputs ----
    t = time.perf_counter()
    nat = phase_native(smoke.build_engine(dev, **smoke.NEURAL, det_prob_wire_bits=4),
                       [*forms, *hindi], smi=smi)
    emit({**nat, "elapsed_s": time.perf_counter() - t})

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
    # packages: CHANGES.md, the bf16 gate)
    t = time.perf_counter()
    hybrid = smoke.build_engine(dev, **expected["settings"], compute_dtype="bfloat16")
    hybrid.process_pages(as_pages(forms[:2]))  # first call: cuDNN/cuBLAS set-up
    h16_records, m16_records = [], []
    h16 = phase_hybrid(hybrid, as_pages(forms), want["bfloat16"], smoke.BF16_WORD_SHARE, 0.98,
                       "hybrid_bf16", leaders_any_length=True,
                       also={"jax_float32": want["float32"]}, records_out=h16_records)
    emit({**h16, "elapsed_s": time.perf_counter() - t})

    # ---- phase 6a: the mixed wave in bf16, its Hindi pages gated too ----
    t = time.perf_counter()
    m16 = phase_hybrid(hybrid, mixed, expected["mixed"]["bfloat16"], smoke.BF16_WORD_SHARE,
                       0.98, "mixed_bf16", leaders_any_length=True,
                       also={"jax_float32": expected["mixed"]["float32"]},
                       hindi=len(hindi), min_hindi_text=0.95, records_out=m16_records)
    emit({**m16, "elapsed_s": time.perf_counter() - t})

    # ---- phase 6s: the served detector's skew angles on the committed
    # forms and their turned copies, bit for bit the JAX record's ----
    t = time.perf_counter()
    emit({**phase_skew(hybrid, expected["skew"], smi=smi), "elapsed_s": time.perf_counter() - t})

    # ---- phase 6a': det and rec device time, FLOPs and MFU of each bf16
    # wave (utils/profiler.det_rec_breakdown), then a device trace of the
    # Latin wave (utils/profiler.device_trace) ----
    for wave, records, tag in ((as_pages(forms), h16_records, "breakdown_latin"),
                               (mixed, m16_records, "breakdown_mixed")):
        t = time.perf_counter()
        emit({**phase_breakdown(hybrid, wave, records, tag, smi=smi),
              "elapsed_s": time.perf_counter() - t})
    t = time.perf_counter()
    emit({**phase_trace(hybrid, as_pages(forms), os.path.join(REPO, "build", "trace"),
                        smi=smi), "elapsed_s": time.perf_counter() - t})

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
    # ---- phase 6e: the service: a scanned PDF uploaded through the HTTP
    # API (App.serve on a socket) to persisted, validated and exported
    # fields, at both dtypes ----
    import tempfile

    upload, want_svc = smoke.service_upload()
    with tempfile.TemporaryDirectory() as root:
        for dtype in ("float32", "bfloat16"):
            t = time.perf_counter()
            # the served engine at the upload's rasterization dpi (the
            # renderer tier reads it; the embedded-image tier does not)
            engine = smoke.build_engine(dev, **expected["settings"], compute_dtype=dtype,
                                        pdf_raster_dpi=smoke.SERVICE_DPI)
            app, orch = service_app(engine, extractors[dtype], root, dtype)
            emit({**phase_service(app, orch, upload, want_svc[dtype], f"service_{dtype}",
                                  dtype == "float32", smi=smi),
                  "elapsed_s": time.perf_counter() - t})
            orch.repos.db.close()
    emit(phase_text_pdf(smi=smi))
    del hybrid32, extractors

    # ---- phase 7: the Latin wave, then the mixed wave, through the
    # scheduler (its det worker routes the second wave's Hindi pages while
    # the first wave's rec runs) ----
    t = time.perf_counter()
    sch = phase_scheduler(hybrid, as_pages([*forms, *hindi, *forms[:expected["mixed_latin"]]]))
    emit({**sch, "elapsed_s": time.perf_counter() - t})

    # ---- phase 8: the host image operations on one form, then the
    # on-device page preprocessing chain on the card against the CPU ----
    emit(phase_host_ops(forms[1]))
    t = time.perf_counter()
    emit({**phase_preprocess_chain(dev, forms, smi=smi), "elapsed_s": time.perf_counter() - t})
    del hybrid

    # ---- phase 8a: the entry points of the JAX package's scripts ----
    with tempfile.TemporaryDirectory() as root:
        t = time.perf_counter()
        emit({**phase_scripts(dev, forms[1], root), "elapsed_s": time.perf_counter() - t})

    # ---- phase 8b: the fonts the renderer reads (the package's), then the
    # detector settings and the quality evaluation against the JAX record ----
    want_eval = smoke.eval_expected()
    emit(phase_fonts(want_eval))
    t = time.perf_counter()
    dets = phase_det_settings(dev, forms[:smoke.DET_SETTINGS_FORMS], expected["settings"],
                              want_eval["det_settings"], smi=smi)
    emit({**dets, "elapsed_s": time.perf_counter() - t})
    kits = {dtype: smoke.eval_kit(dev, dtype) for dtype in ("float32", "bfloat16")}
    arrays = smoke.eval_renders()
    for name in smoke.EVAL_PHASES:
        t = time.perf_counter()
        emit({**phase_eval(name, kits, want_eval["phases"][name],
                           renders=(want_eval["renders"][name], arrays)),
              "elapsed_s": time.perf_counter() - t})
    del kits

    # ---- phase 9: training: 3 steps of each trainer on its committed
    # batch from the trained weights, against the JAX record (float32
    # within its bar, bf16 reported), then train_layout end to end ----
    want_train, spread = smoke.train_expected(), smoke.train_spread()
    bars = {}  # the float32 bar each one-device step was held to
    for name in smoke.TRAIN_NAMES:
        for dtype in ("float32", "bfloat16"):
            t = time.perf_counter()
            row = phase_train(name, dtype, dev, want_train, spread["float32"], smi,
                              strict=spread["bfloat16_strict"])
            emit({**row, "elapsed_s": time.perf_counter() - t})
            if dtype == "float32":
                bars[name] = row["spread"]
                t = time.perf_counter()
                emit({**phase_train_tf32_control(name, dev, want_train, row["exact"]),
                      "elapsed_s": time.perf_counter() - t})
    t = time.perf_counter()
    emit({**phase_train_layout_cli(dev, smi=smi), "elapsed_s": time.perf_counter() - t})
    for name in ("rec", "det"):
        t = time.perf_counter()
        emit({**phase_train_cli(name, dev, smi=smi), "elapsed_s": time.perf_counter() - t})

    # ---- phase 10: the parallel layer. The real default mesh (dp=-1: one
    # card here), then virtual meshes of this card named VIRTUAL times:
    # the served wave split over dp, extraction with ring attention over
    # sp, the train steps over dp (and tp), GPipe over pp, and the dry
    # run of every mesh path ----
    from ocr_system_tpu_torch.core.mesh import get_mesh

    t_mc = time.perf_counter()
    default_mesh = get_mesh()
    if default_mesh.shape != {"dp": torch.cuda.device_count()}:
        raise AssertionError(f"the default mesh is {default_mesh}")
    emit({"phase": "multichip_default_mesh", "mesh": mesh_row(default_mesh),
          "mesh_shape_setting": Settings().mesh_shape})
    t = time.perf_counter()
    mc_wave = phase_dp_wave(dev, as_pages(forms), want["float32"],
                            {**expected["settings"], "compute_dtype": "float32"},
                            default_mesh, smi=smi)
    emit({**mc_wave, "elapsed_s": time.perf_counter() - t})
    t = time.perf_counter()
    emit({**phase_sp_extract(dev, docs, want_ex["docs"]["float32"], smi=smi),
          "elapsed_s": time.perf_counter() - t})
    for name, spec in (("rec", "dp=-1"), ("det", "dp=-1"), ("layout", "dp=2,tp=2")):
        t = time.perf_counter()
        emit({**phase_train_mesh(name, dev, want_train, bars[name], virtual_mesh(spec, dev),
                                 smi=smi), "elapsed_s": time.perf_counter() - t})
    t = time.perf_counter()
    emit({**phase_gpipe(dev, smi=smi), "elapsed_s": time.perf_counter() - t})
    from ocr_system_tpu_torch.utils.multichip import dryrun_multichip

    t = time.perf_counter()
    emit({"phase": "multichip_dryrun", **dryrun_multichip(VIRTUAL, devices=[dev] * VIRTUAL),
          "elapsed_s": time.perf_counter() - t})
    emit({"phase": "multichip", "elapsed_s": time.perf_counter() - t_mc})

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
            # the virtual dp wave's launches on each of its dp shards
            "launches_per_dp_shard": mc_wave["launches_per_shard"][name],
        })
    # the native host ops (not TPU kernels): calls on the served waves,
    # ms per page against the plain version, on this host
    prob_wave = dets["settings"]["prob_wire_4"]["native_calls"]
    native = []
    for name, row in nat["ops"].items():
        fn = name.split("_stride")[0]
        src, replaces = NATIVE_SOURCES[fn]
        native.append({
            "name": name, "source": f"{PKG}/native/{src}", "replaces": replaces,
            "calls": {"hybrid_bf16": h16["native_calls"][fn], "mixed_bf16": m16["native_calls"][fn],
                      "scheduler": sch["native_calls"][fn], "prob_wire_4": prob_wave[fn]},
            "ms": row["ms"], "plain_ms": row["plain_ms"], "max_rel_err": row["max_rel_err"]})
    emit({"native": native, "gxx": nat["gxx"], "build_s": nat["build_s"]})
    emit({"kernels": kernels, "total_s": time.perf_counter() - t_all})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
