"""The smoke workload of chip_smoke.py and utils/profile_wave.py: the
port's engines with the trained weights (``weights/*.npz``, written by
export_torch_weights.py), the committed Latin and Hindi synthetic forms
and glued-lines page and the JAX package's outputs on them (``assets/``),
and synthetic pages and checkboxes drawn with numpy from a seed; the
record and comparison of a page's layout, routing and rescues against
those outputs; the extraction documents built from those outputs and the
record and comparison of their fields, field rows and validation reports
against the JAX package's (``assets/extract_expected.json``); the
trainers' committed batches, start weights and the JAX package's record of
3 steps on them (``assets/train_*``); and the bf16 agreement rules that
chip_smoke.py and the tests share."""

from __future__ import annotations

import csv
import io
import json
import re
import zlib
from pathlib import Path

import numpy as np
import torch

from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine.host_image import rgb_to_gray
from ocr_system_tpu_torch.engine.pipeline import (
    TorchOCREngine,
    _build_engine,
    combine_markdown,
    get_engine,
)

PACKAGE = Path(__file__).resolve().parents[1]
TRAINED = {
    "det_checkpoint": str(PACKAGE / "weights" / "det.npz"),
    "rec_checkpoint": str(PACKAGE / "weights" / "rec_latin.npz"),
    "rec_checkpoint_devanagari": str(PACKAGE / "weights" / "rec_devanagari.npz"),
}
# the neural engine alone (no classical pass, marks, handwriting or glue
# split)
NEURAL = {
    "ocr_engine": "jax",
    "enable_selection_marks": False,
    "enable_handwriting_detection": False,
    "det_glue_split": False,
}
FORMS = PACKAGE / "assets" / "smoke_forms.npz"
HINDI = PACKAGE / "assets" / "hindi_forms.npz"
EXPECTED = PACKAGE / "assets" / "smoke_forms_expected.json"
GLUED = PACKAGE / "assets" / "glued_lines.npz"
GLUED_EXPECTED = PACKAGE / "assets" / "glued_lines_expected.json"
EXTRACT_EXPECTED = PACKAGE / "assets" / "extract_expected.json"
# the service phase's upload: the committed Latin forms as a scanned PDF,
# and the JAX application's extraction of it
TRAIN_BATCHES = PACKAGE / "assets" / "train_batches.npz"
TRAIN_EXPECTED = PACKAGE / "assets" / "train_expected.json"
TRAIN_SPREAD = PACKAGE / "assets" / "train_spread.json"
SERVICE_UPLOAD = PACKAGE / "assets" / "service_upload.pdf"
SERVICE_EXPECTED = PACKAGE / "assets" / "service_expected.json"
# 72 dpi: one PDF point per pixel, so that the renderer pastes each page
# image 1:1 (at 300 dpi a 960 px image spans 230.4 pt, and the paste's
# int() corners give 959 px and a resize)
SERVICE_DPI = 72
# the text PDF of the PDF parity tests, rendered at TEXT_PDF_DPI by the
# JAX package on a host with the system's DejaVu and PIL with raqm (the
# gray plane; export_torch_weights.py --only text_pdf writes it)
TEXT_PDF_RENDER = PACKAGE / "assets" / "text_pdf_render.npz"
TEXT_PDF_DPI = 150

# A bf16 kernel output equals its plain version's float32 result rounded to
# bf16, except by at most one bf16 ulp on at most this share of elements:
# float32 results that differ within 1e-5 may straddle a rounding boundary.
BF16_MAX_ULPS = 1.0
BF16_MAX_SHARE = 1e-3


def bf16_disagreement(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """got (bf16) against ref (float32) rounded to bf16: the largest
    distance in bf16 ulps (of the larger magnitude) and the share of
    elements that differ at all."""
    want = ref.float().to(torch.bfloat16).float()
    have = got.float()
    mag = torch.maximum(want.abs(), have.abs()).clamp_min(2.0 ** -126)
    ulps = (have - want).abs() / torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(ulps.max()), float((ulps > 0).float().mean())


def bf16_agrees(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """The rule above, for tests and chip_smoke.py."""
    worst, share = bf16_disagreement(got, ref)
    return worst <= BF16_MAX_ULPS and share <= BF16_MAX_SHARE


def build_engine(device, **overrides) -> TorchOCREngine:
    """``get_engine`` of the serving defaults + overrides with the trained
    weights."""
    return get_engine(Settings(**{**TRAINED, **overrides}), device=device)


def new_engine(device, **overrides) -> TorchOCREngine:
    """A new engine of the serving defaults + overrides with the trained
    weights, not ``get_engine``'s shared one: an engine resolves its mesh
    at its first wave, so each mesh needs its own."""
    s = Settings(**{**TRAINED, **overrides})
    return _build_engine(s.ocr_engine, s, device)


def smoke_forms() -> tuple[np.ndarray, dict]:
    """The committed Latin forms, (N, 960, 960, 3) uint8, and the JAX
    package's outputs (their settings, and per compute dtype a page_record
    per page: of the Latin forms under "pages", of the mixed wave of the
    Hindi forms and the first ``mixed_latin`` Latin forms under
    "mixed")."""
    with np.load(FORMS) as z:
        pages = z["pages"]
    return pages, json.loads(EXPECTED.read_text())


def hindi_forms() -> np.ndarray:
    """The committed Hindi forms, (N, 960, 960, 3) uint8."""
    with np.load(HINDI) as z:
        return z["pages"]


# the skew gate's turned pages: (wave, form index, degrees counter-clockwise).
# The corrections -5, -9 and -2 land on candidates where torch's linspace
# and XLA's differ (as do the 2 degrees that Latin form 1 and Hindi forms 2
# and 3 carry), 4 and 6 on whole ones; 13 more than Hindi form 3's own 2
# fails the search's margin
SKEW_TURNS = (("latin", 1, 5.0), ("latin", 2, -4.0), ("latin", 5, 9.0),
              ("hindi", 0, -6.0), ("hindi", 2, 13.0), ("latin", 6, 2.0))


def skew_pages() -> tuple[list[str], list[np.ndarray]]:
    """The skew gate's pages and their names: every committed Latin and
    Hindi form as it is, then the ``SKEW_TURNS`` copies
    (``host_image.rotate_cubic``, white outside)."""
    from ocr_system_tpu_torch.engine.host_image import rotate_cubic

    waves = {"latin": smoke_forms()[0], "hindi": hindi_forms()}
    names = [f"{w}/{i + 1}" for w, arr in waves.items() for i in range(len(arr))]
    pages = [np.ascontiguousarray(p) for arr in waves.values() for p in arr]
    for wave, i, deg in SKEW_TURNS:
        names.append(f"{wave}/{i + 1} turned {deg:g}")
        pages.append(rotate_cubic(waves[wave][i], deg))
    return names, pages


def glued_lines() -> tuple[np.ndarray, np.ndarray, list[str], dict]:
    """The committed glued-lines page, (H, W, 3) uint8, its lines' (N, 4, 2)
    quads and glued decodes, and the JAX package's glue split of them per
    compute dtype (the quads and texts after the pass, and the det score
    and rec confidence the boxes carried in)."""
    with np.load(GLUED) as z:
        page, quads, texts = z["page"], z["quads"], [str(t) for t in z["texts"]]
    return page, quads, texts, json.loads(GLUED_EXPECTED.read_text())


def draw_page(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A white page with rows of dark word-like bars, (h, w, 3) uint8."""
    img = np.full((h, w, 3), 248, np.uint8)
    row_h = max(h // 40, 6)
    for y in range(row_h * 2, h - row_h * 2, row_h * 2):
        x = w // 20
        while x < w - w // 10:
            bw = int(rng.integers(w // 40, w // 8))
            img[y:y + row_h, x:min(x + bw, w - w // 20)] = int(rng.integers(10, 60))
            x += bw + int(rng.integers(w // 60, w // 25))
    return img


def draw_checkboxes(page: np.ndarray, rng: np.random.Generator, n: int) -> np.ndarray:
    """A copy of an (H, W, 3) uint8 page with n checkbox outlines drawn in
    blank places (2-px dark squares of 1/50 of the page side, every other
    one checked with a cross), so the selection-mark pass has marks to
    find."""
    from scipy import ndimage

    out = page.copy()
    h, w = page.shape[:2]
    side = max(round(max(h, w) / 50), 10)
    margin = side // 2
    gray = rgb_to_gray(page)
    # top-left corners whose box and margin lie on blank page
    blank = ndimage.minimum_filter(gray, size=side + 2 * margin, mode="constant", cval=0) > 200
    ys, xs = np.nonzero(blank[: h - side - margin, : w - side - margin])
    taken = np.zeros((h, w), bool)
    for k in range(n):
        free = ~taken[ys, xs]
        if not free.any():
            break
        j = int(rng.choice(np.flatnonzero(free)))
        y0, x0 = int(ys[j]) - side // 2, int(xs[j]) - side // 2
        y0, x0 = max(y0, 0), max(x0, 0)
        box = out[y0: y0 + side, x0: x0 + side]
        box[:2], box[-2:], box[:, :2], box[:, -2:] = 30, 30, 30, 30
        if k % 2 == 0:  # checked: a cross inside the outline
            for t in range(4, side - 4):
                box[t, t - 1: t + 1] = 30
                box[t, side - t - 1: side - t + 1] = 30
        taken[max(y0 - side, 0): y0 + 2 * side, max(x0 - side, 0): x0 + 2 * side] = True
    return out


LAYOUT_TYPES = ("word", "line", "table", "selection_mark", "handwriting")


def page_record(out, routed: dict | None = None, rescued: dict | None = None) -> dict:
    """An OCROutput (of either package) as the JSON record that the
    committed smoke expectations hold: its layout boxes by type (polygon,
    content, and a mark's state) and its markdown; with ``routed`` (the
    page's ``pipeline.box_recognizers``) each word's recognizer, and with
    ``rescued`` the crops each rescue re-decoded and replaced."""
    rec: dict = {"page_number": out.page_number, "markdown": out.markdown}
    for typ in LAYOUT_TYPES:
        rec[typ] = [
            {"polygon": [float(v) for v in b["polygon"]],
             "content": b.get("content", ""),
             **({"state": b["state"]} if "state" in b else {})}
            for b in out.layout_boxes if b["type"] == typ
        ]
    if routed is not None:
        for w in rec["word"]:
            w["recognizer"] = routed[tuple(w["polygon"])]
    if rescued is not None:
        rec["rescued"] = rescued
    return rec


def box_iou(a: list[float], b: list[float]) -> float:
    """IoU of two flat 8-number polygons' axis-aligned extents."""
    ax, ay, bx, by = a[0::2], a[1::2], b[0::2], b[1::2]
    ix = max(0.0, min(max(ax), max(bx)) - max(min(ax), min(bx)))
    iy = max(0.0, min(max(ay), max(by)) - max(min(ay), min(by)))
    inter = ix * iy
    area_a = (max(ax) - min(ax)) * (max(ay) - min(ay))
    area_b = (max(bx) - min(bx)) * (max(by) - min(by))
    return inter / max(area_a + area_b - inter, 1e-9)


# bf16 serving against the JAX package's bf16 on the same pages: at least
# this share of its words matched, dot-leader runs compared regardless of
# length (``same_text(..., leaders_any_length=True)``). A run of dots
# decodes one dot longer or shorter under small changes of bf16 rounding:
# the JAX package's own bf16 texts of the committed forms move on up to
# 11% of the words when only XLA's CPU options change, nearly all of them
# dot leaders (CHANGES.md, the bf16 gate).
BF16_WORD_SHARE = 0.98
_LEADER = re.compile(r"\.{2,}")


def same_text(a: str, b: str, leaders_any_length: bool = False) -> bool:
    """Whether two recognised texts agree; with ``leaders_any_length``,
    every run of two or more dots counts as one dot leader whatever its
    length."""
    if leaders_any_length:
        return _LEADER.sub("..", a) == _LEADER.sub("..", b)
    return a == b


def _match_words(expected: list[dict], got: list[dict], leaders_any_length: bool):
    """Greedy one-to-one matching: each expected word takes the free port
    word of the highest IoU; it matches if that IoU is >= 0.9 and the texts
    agree. Returns (matched, misses)."""
    free = list(got)
    matched, misses = 0, []
    for w in expected:
        best = max(range(len(free)), key=lambda k: box_iou(w["polygon"], free[k]["polygon"]),
                   default=None)
        if (best is not None and box_iou(w["polygon"], free[best]["polygon"]) >= 0.9
                and same_text(free[best]["content"], w["content"], leaders_any_length)):
            matched += 1
            free.pop(best)
        else:
            misses.append({"expected": w, "got": None if best is None else free[best]})
    return matched, misses


def compare_to_expected(expected: dict, got: dict) -> dict:
    """One page's record against its expectation: the expected words that a
    port word with IoU >= 0.9 and the same text matches (each port word
    used once; ``matched``, and ``matched_leaders`` with dot-leader runs of
    any length alike), the expected words that a port box with IoU >= 0.9
    covers whatever its text, and whether the selection marks (count and
    states, in order) and the handwriting boxes (count) agree. Text misses
    (exact texts) are listed. Where both records carry them: the expected
    words whose best port box (IoU >= 0.9) went to another recognizer
    (``recognizer_misses``), and whether the rescue counts are equal
    (``rescued_ok``; None where either record lacks them)."""
    matched, misses = _match_words(expected["word"], got["word"], False)
    matched_leaders, _ = _match_words(expected["word"], got["word"], True)
    boxes = 0
    recognizer_misses = []
    for w in expected["word"]:
        best = max(got["word"], key=lambda g: box_iou(w["polygon"], g["polygon"]), default=None)
        if best is None or box_iou(w["polygon"], best["polygon"]) < 0.9:
            continue
        boxes += 1
        if "recognizer" in w and w["recognizer"] != best.get("recognizer"):
            recognizer_misses.append({"expected": w, "got": best})
    marks_ok = ([m["state"] for m in expected["selection_mark"]]
                == [m["state"] for m in got["selection_mark"]])
    hand_ok = len(expected["handwriting"]) == len(got["handwriting"])
    rescued_ok = (expected["rescued"] == got["rescued"]
                  if "rescued" in expected and "rescued" in got else None)
    return {"words": len(expected["word"]), "matched": matched,
            "matched_leaders": matched_leaders, "boxes_matched": boxes,
            "misses": misses, "marks_ok": marks_ok, "handwriting_ok": hand_ok,
            "recognizer_misses": recognizer_misses, "rescued_ok": rescued_ok}


def text_share(expected: list[dict], got: list[dict]) -> float:
    """The share of the expected pages' words that ``got`` matches (box
    and text), over all pages."""
    rows = [compare_to_expected(e, g) for e, g in zip(expected, got)]
    return sum(r["matched"] for r in rows) / max(sum(r["words"] for r in rows), 1)


# ---- extraction ----

def extract_documents(expected: dict) -> dict[str, tuple[list[dict], tuple[float, float], str]]:
    """The extraction inputs that the JAX record (``extract_expected.json``)
    was made from: the JAX package's float32 OCR words of each committed
    page as a one-page document ("pages/1" .. "pages/8" for the Latin wave,
    "mixed/1" .. "mixed/8" for the mixed wave), and the Latin wave as one
    8-page document ("pages"). Each is (word boxes, page size, markdown),
    the first arguments of ``extract_from_layout``."""
    side = float(expected["side"])

    def words(rec: dict, page: int) -> list[dict]:
        return [{"type": "word", "content": w["content"], "polygon": w["polygon"],
                 "page_number": page} for w in rec["word"]]

    docs = {}
    for wave in ("pages", "mixed"):
        for rec in expected[wave]["float32"]:
            docs[f"{wave}/{rec['page_number']}"] = (words(rec, 1), (side, side), rec["markdown"])
    latin = expected["pages"]["float32"]
    docs["pages"] = ([w for rec in latin for w in words(rec, rec["page_number"])],
                     (side, side), combine_markdown([rec["markdown"] for rec in latin]))
    return docs


def extract_expected() -> dict:
    """The JAX package's extraction record (export_torch_weights.py)."""
    return json.loads(EXTRACT_EXPECTED.read_text())


def result_record(result) -> dict:
    """An ExtractionResult (of either package) as its JSON record: each
    field as [key, value, type, confidence], the form type, language,
    raw_response and token count."""
    return {"fields": [[f.field_key, f.field_value, f.field_type, f.confidence]
                       for f in result.fields],
            "form_type": result.form_type, "language": result.language,
            "raw_response": result.raw_response, "token_count": result.token_count}


ROW_KEYS = ("field_key", "field_value", "field_type", "confidence", "key_bbox", "value_bbox",
            "page_number")
REPORT_KEYS = ("is_valid", "message", "severity", "corrected_value", "needs_review",
               "confidence_level")


def rows_record(rows: list[dict]) -> list[dict]:
    """Field rows (the save stage's) as JSON records."""
    return [{k: r[k] for k in ROW_KEYS} for r in rows]


def report_record(report) -> dict:
    """A validation report (of either package) as its JSON record, its
    results in row order."""
    return {"total_fields": report.total_fields, "valid_fields": report.valid_fields,
            "invalid_fields": report.invalid_fields, "needs_review": report.needs_review,
            "results": [{k: getattr(r, k) for k in REPORT_KEYS}
                        for r in report.results.values()]}


def compare_fields(expected: dict, got: dict) -> dict:
    """One document's extraction record against the JAX one: whether the
    fields are equal in key, value and type, in order
    (``fields_equal``), the largest confidence difference between them
    (None unless they are), whether the form type and raw_response are
    equal, and the share of the expected fields that a got field equals in
    key, value and type, each used once (``matched`` of ``fields``);
    ``misses`` lists the expected fields no got field matched."""
    want = [tuple(f[:3]) for f in expected["fields"]]
    have = [tuple(f[:3]) for f in got["fields"]]
    free = list(have)
    misses = []
    for f in want:
        if f in free:
            free.remove(f)
        else:
            misses.append(list(f))
    equal = want == have
    return {"fields": len(want), "matched": len(want) - len(misses), "misses": misses,
            "extra": [list(f) for f in free], "fields_equal": equal,
            "max_conf_diff": max((abs(a[3] - b[3]) for a, b in zip(expected["fields"],
                                                                     got["fields"])),
                                 default=0.0) if equal else None,
            "form_type_equal": expected["form_type"] == got["form_type"],
            "raw_response_equal": expected["raw_response"] == got["raw_response"]}


def _max_poly_diff(a: dict | None, b: dict | None) -> float | None:
    """Largest coordinate difference of two bbox matches' polygons, None if
    only one matched or their texts or pages differ."""
    if a is None or b is None:
        return 0.0 if a is b else None
    if (a["matched_text"], a["page"]) != (b["matched_text"], b["page"]):
        return None
    return max(abs(x - y) for x, y in zip(a["polygon"], b["polygon"]))


def compare_rows(expected: list[dict], got: list[dict], conf_tol: float,
                 poly_tol: float) -> dict:
    """Field rows against the JAX package's: equal in count, and row for row
    in key, value, type and page, confidences within ``conf_tol``, key and
    value boxes matched to the same text on the same page with polygons
    within ``poly_tol`` pixels. Returns the rows that differ and the
    largest confidence and polygon differences."""
    bad, conf_d, poly_d = [], 0.0, 0.0
    for i, (e, g) in enumerate(zip(expected, got)):
        same = all(e[k] == g[k] for k in ("field_key", "field_value", "field_type",
                                           "page_number"))
        conf_d = max(conf_d, abs(e["confidence"] - g["confidence"]))
        polys = [_max_poly_diff(e[k], g[k]) for k in ("key_bbox", "value_bbox")]
        if not same or None in polys or abs(e["confidence"] - g["confidence"]) > conf_tol:
            bad.append({"row": i, "expected": e, "got": g})
            continue
        poly_d = max(poly_d, *polys)
        if max(polys) > poly_tol:
            bad.append({"row": i, "expected": e, "got": g})
    if len(expected) != len(got):
        bad.append({"rows": [len(expected), len(got)]})
    return {"rows": len(expected), "rows_differing": bad, "max_conf_diff": conf_d,
            "max_poly_diff": poly_d}


# ---- the service phase: masking what differs between two runs ----

_UUID = re.compile(r"[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}")
_ISO_TIME = re.compile(r"\d{4}-\d{2}-\d{2}[T ]\d{2}:\d{2}:\d{2}(\.\d+)?(\+00:00|Z)?")
_STAMP = re.compile(r"\d{8}_\d{6}(_[0-9a-f]{8})?")
# wall-clock measurements in rows and responses
TIMING_KEYS = ("ocr_time_ms", "llm_time_ms", "processing_time_ms", "duration_ms", "uptime_s",
               "avg_total_ms", "avg_ocr_ms", "avg_extraction_ms", "stage_times_ms")


def masked(obj, ids: dict | None = None, paths: tuple[str, ...] = ()):
    """A JSON-like value with what two runs of the same requests do not
    share replaced: each uuid by ``<id:n>`` (n numbers the distinct ids in
    order of appearance, so that references between rows stay checked),
    timestamps by ``<time>``, stored-file stamps by ``<stamp>``, each of
    ``paths`` (run directories) by ``<dir>``, and the values under
    ``TIMING_KEYS`` by ``<ms>``."""
    ids = {} if ids is None else ids

    def text(s: str) -> str:
        for p in paths:
            s = s.replace(p, "<dir>")
        s = _UUID.sub(lambda m: ids.setdefault(m.group(0), f"<id:{len(ids)}>"), s)
        return _STAMP.sub("<stamp>", _ISO_TIME.sub("<time>", s))

    if isinstance(obj, dict):
        return {text(str(k)) if isinstance(k, str) else k:
                ("<ms>" if k in TIMING_KEYS and v is not None else masked(v, ids, paths))
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [masked(v, ids, paths) for v in obj]
    if isinstance(obj, str):
        return text(obj)
    return obj


def scanned_pdf(pages: list[np.ndarray]) -> bytes:
    """(H, W) uint8 gray pages as a scanned PDF: per page a MediaBox of W x
    H points and one FlateDecode DeviceGray image XObject drawn over it
    (``W 0 0 H 0 0 cm``), with a cross-reference table; at ``SERVICE_DPI``
    a renderer pastes each image 1:1."""
    objs: list[bytes] = []

    def add(body: bytes) -> int:
        objs.append(body)
        return len(objs)

    add(b"<< /Type /Catalog /Pages 2 0 R >>")
    add(b"")  # the page tree, filled in below
    kids = []
    for page in pages:
        h, w = page.shape
        data = zlib.compress(np.ascontiguousarray(page, np.uint8).tobytes(), 9)
        img = add(b"<< /Type /XObject /Subtype /Image /Width %d /Height %d /ColorSpace "
                  b"/DeviceGray /BitsPerComponent 8 /Filter /FlateDecode /Length %d >>\n"
                  b"stream\n%s\nendstream" % (w, h, len(data), data))
        draw = b"q %d 0 0 %d 0 0 cm /Im0 Do Q" % (w, h)
        content = add(b"<< /Length %d >>\nstream\n%s\nendstream" % (len(draw), draw))
        kids.append(add(b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 %d %d] /Resources "
                        b"<< /XObject << /Im0 %d 0 R >> >> /Contents %d 0 R >>"
                        % (w, h, img, content)))
    objs[1] = (b"<< /Type /Pages /Kids [%s] /Count %d >>"
               % (b" ".join(b"%d 0 R" % k for k in kids), len(kids)))
    out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = []
    for i, body in enumerate(objs, 1):
        offsets.append(len(out))
        out += b"%d 0 obj\n%s\nendobj\n" % (i, body)
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)
    out += b"".join(b"%010d 00000 n \n" % o for o in offsets)
    out += b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n" % (
        len(objs) + 1, xref)
    return bytes(out)


def text_pdf() -> bytes:
    """A one-page text PDF (Helvetica, drawn in DejaVu Sans by the
    renderer): two text lines, a TJ array with a kerning gap, a stroked rule
    and a gray filled rectangle; tests/test_torch_pdf.py's ``text_pdf()``."""
    content = (
        b"BT /F1 24 Tf 72 700 Td (INVOICE 2024-001) Tj ET\n"
        b"BT /F1 14 Tf 72 650 Td (Total Amount: $1,234.56) Tj ET\n"
        b"BT /F1 14 Tf 72 620 Td [(Customer:) -500 (Jane Doe)] TJ ET\n"
        b"1 w 70 600 m 400 600 l S\n"
        b"0.8 g 70 520 200 40 re f\n"
    )
    objs = [
        b"<< /Type /Catalog /Pages 2 0 R >>",
        b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 612 792] /Rotate 0 "
        b"/Resources << /Font << /F1 4 0 R >> >> /Contents 5 0 R >>",
        b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
        b"<< /Length %d >>\nstream\n%s\nendstream" % (len(content), content),
    ]
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for i, body in enumerate(objs, start=1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref_at = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objs) + 1)
    out += b"".join(b"%010d 00000 n \n" % off for off in offsets)
    out += (b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF"
            % (len(objs) + 1, xref_at))
    return bytes(out)


def text_pdf_render() -> np.ndarray:
    """The committed gray render of ``text_pdf()`` (module note)."""
    with np.load(TEXT_PDF_RENDER) as z:
        return z["gray"]


def service_upload() -> tuple[bytes, dict]:
    """The committed upload PDF and the JAX application's record of it."""
    return SERVICE_UPLOAD.read_bytes(), json.loads(SERVICE_EXPECTED.read_text())


def service_record(extraction: dict, json_export: bytes, csv_export: bytes) -> dict:
    """What the service phase holds of one processed upload: from the current
    extraction (``GET /api/extractions/document/{id}``) its markdown, form
    type, page dimensions, layout box count and fields in order (key,
    value, type, confidence, page, key and value boxes, validation), the
    validation counts, and the JSON and CSV exports, masked."""
    fields = extraction["fields"]
    layout = extraction.get("layout_data") or []
    return {
        "markdown": extraction["raw_ocr_markdown"],
        "form_type": extraction["form_type"],
        "language": extraction["language"],
        "model_name": extraction["model_name"],
        "page_dimensions": extraction["page_dimensions"],
        "layout_boxes": len(layout),
        "fields": [{"key": f["field_key"], "value": f["field_value"], "type": f["field_type"],
                    "order": f["sort_order"], "confidence": f["confidence"],
                    "page": f["page_number"], "key_bbox": f["key_bbox"],
                    "value_bbox": f["value_bbox"], "is_valid": f["is_valid"],
                    "needs_review": f["needs_review"]} for f in fields],
        "validation": {"total": extraction["total_fields"],
                       "valid": sum(f["is_valid"] is True for f in fields),
                       "invalid": sum(f["is_valid"] is False for f in fields),
                       "needs_review": sum(bool(f["needs_review"]) for f in fields),
                       "high_confidence": extraction["high_confidence_count"],
                       "low_confidence": extraction["low_confidence_count"]},
        "json_export": masked(json.loads(json_export)),
        "csv_export": list(csv.reader(io.StringIO(csv_export.decode("utf-8")))),
    }


def _close(a, b, tol: float) -> bool:
    """JSON-like values equal, floats within ``tol`` (CSV cells that read
    as floats included)."""
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], tol) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_close(x, y, tol) for x, y in zip(a, b))
    if isinstance(a, float) or isinstance(b, float):
        return (isinstance(a, (int, float)) and isinstance(b, (int, float))
                and not isinstance(a, bool) and abs(a - b) <= tol)
    if isinstance(a, str) and isinstance(b, str) and a != b:
        try:
            return "." in a and abs(float(a) - float(b)) <= tol
        except ValueError:
            return False
    return a == b


def compare_service(expected: dict, got: dict, conf_tol: float, poly_tol: float) -> dict:
    """A service record against the JAX application's: the fields equal in
    key, value, type and order (``fields_equal``) with confidences within
    ``conf_tol``, pages and validation equal and key and value boxes
    matched to the same text within ``poly_tol`` px (``rows_equal``), the
    validation counts equal, the JSON and CSV exports equal with floats
    within ``conf_tol``; the share of the expected fields that a got field
    equals in key, value and type; the markdown, form type and layout
    count compared (reported)."""
    want = [(f["key"], f["value"], f["type"], f["order"]) for f in expected["fields"]]
    have = [(f["key"], f["value"], f["type"], f["order"]) for f in got["fields"]]
    free = [h[:3] for h in have]
    matched = 0
    for w in want:
        if w[:3] in free:
            free.remove(w[:3])
            matched += 1
    equal = want == have
    conf_d = poly_d = 0.0
    rows_bad = []
    if equal:
        for i, (e, g) in enumerate(zip(expected["fields"], got["fields"])):
            conf_d = max(conf_d, abs(e["confidence"] - g["confidence"]))
            polys = [_max_poly_diff(e[k], g[k]) for k in ("key_bbox", "value_bbox")]
            same = all(e[k] == g[k] for k in ("page", "is_valid", "needs_review"))
            if None in polys or not same or max(polys) > poly_tol:
                rows_bad.append(i)
            else:
                poly_d = max(poly_d, *polys)
    return {"fields": len(want), "matched": matched,
            "field_share": matched / max(len(want), 1), "fields_equal": equal,
            "max_conf_diff": conf_d if equal else None,
            "rows_equal": equal and not rows_bad and conf_d <= conf_tol,
            "rows_differing": rows_bad, "max_poly_diff": poly_d,
            "validation_equal": expected["validation"] == got["validation"],
            "json_equal": _close(expected["json_export"], got["json_export"], conf_tol),
            "csv_equal": _close(expected["csv_export"], got["csv_export"], conf_tol),
            "markdown_equal": expected["markdown"] == got["markdown"],
            "form_type_equal": expected["form_type"] == got["form_type"],
            "layout_boxes": [expected["layout_boxes"], got["layout_boxes"]]}


def multipart(data: bytes, filename: str, fields: dict | None = None,
              boundary: str = "smokeboundary") -> tuple[bytes, str]:
    """A multipart/form-data body with ``fields`` and one file part named
    "file", and its content type."""
    parts = [f'--{boundary}\r\nContent-Disposition: form-data; name="{k}"\r\n\r\n{v}\r\n'.encode()
             for k, v in (fields or {}).items()]
    parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
                 f'filename="{filename}"\r\nContent-Type: application/pdf\r\n\r\n'.encode()
                 + data + b"\r\n")
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), \
        f"multipart/form-data; boundary={boundary}"


def app_upload(app, request_cls, data: bytes, filename: str) -> dict:
    """An upload through an application's ``handle`` in this process (either
    package's ``App`` and its ``Request`` class): POST it with
    ``auto_extract``, run the background extraction to its end, then read
    the current extraction and its JSON and CSV exports; returns the
    ``service_record``."""
    import asyncio

    async def call(method: str, path: str, body: bytes = b"", ctype: str = ""):
        resp, bg = await app.handle(request_cls(
            method=method, path=path, query={}, body=body, client_ip="127.0.0.1",
            headers={"content-type": ctype} if ctype else {}))
        await bg.run()
        if resp.status >= 300:
            raise AssertionError(f"{method} {path}: {resp.status} {resp.body[:300]!r}")
        return resp.body

    body, ctype = multipart(data, filename, {"auto_extract": "true"})
    doc = json.loads(asyncio.run(call("POST", "/api/documents/upload", body, ctype)))
    ext = json.loads(asyncio.run(call("GET", f"/api/extractions/document/{doc['id']}")))
    if ext["status"] != "completed":
        raise AssertionError(f"extraction {ext['status']}: {ext.get('error_message')}")
    exports = [asyncio.run(call("GET", f"/api/exports/extraction/{ext['id']}/{fmt}"))
               for fmt in ("json", "csv")]
    return service_record(ext, *exports)


# ---------------- training ----------------

TRAIN_NAMES = ("rec", "det", "layout")


def digest(arrays) -> str:
    """sha256 of a mapping of arrays (numpy or torch), keys sorted: names,
    dtypes, shapes and bytes. The JAX training record keeps the digests of
    the batches and start weights it was computed from."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(arrays):
        v = arrays[k]
        a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        h.update(f"{k}:{a.dtype}:{a.shape}:".encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def train_batches() -> dict[str, dict[str, np.ndarray]]:
    """The committed batch of each trainer (``TRAIN_BATCHES``: arrays under
    ``<trainer>/<key>``)."""
    out: dict[str, dict[str, np.ndarray]] = {}
    with np.load(TRAIN_BATCHES) as z:
        for key in z.files:
            name, k = key.split("/", 1)
            out.setdefault(name, {})[k] = z[key]
    return out


def train_expected() -> dict:
    return json.loads(TRAIN_EXPECTED.read_text())


def train_spread() -> dict:
    return json.loads(TRAIN_SPREAD.read_text())


def train_start(name: str) -> dict[str, torch.Tensor]:
    """A trainer's float32 start weights from the committed files: rec the
    Latin recognizer, det the detector with its training threshold head
    (``weights/det_thresh.npz``), layout the served bf16-but-LayerNorm
    extractor, widened to float32."""
    from ocr_system_tpu_torch.core.weights import load_npz

    w = PACKAGE / "weights"
    if name == "rec":
        state = load_npz(w / "rec_latin.npz")
    elif name == "det":
        state = {**load_npz(w / "det.npz"), **load_npz(w / "det_thresh.npz")}
    else:
        state = load_npz(w / "extract.npz")
    return {k: v.float() for k, v in state.items()}


def _rel(a, b) -> float:
    """Largest |a - b| over the largest |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def train_deviation(got: dict, ref: dict) -> dict:
    """One trainer's record ``got`` against ``ref`` (the JAX record's rows:
    per step the loss, the gradient norm, the layout tag accuracy; after
    the last step the parameter-group norms and BatchNorm statistics), each
    number as its relative deviation (tag accuracy: absolute)."""
    out = {"loss": [_rel(a, b) for a, b in zip(got["loss"], ref["loss"], strict=True)],
           "grad_norm": _rel(got["grad_norm"][0], ref["grad_norm"][0]),
           "group_norms": {g: _rel(got["group_norms"][g], v)
                           for g, v in ref["group_norms"].items()}}
    if "tag_acc" in ref:
        out["tag_acc"] = [abs(a - b) for a, b in zip(got["tag_acc"], ref["tag_acc"])]
    if "bn" in ref:
        out["bn"] = {m: {k: _rel(got["bn"][m][k], v) for k, v in stats.items()}
                     for m, stats in ref["bn"].items()}
    return out


# ---------------- quality evaluation ----------------

EVAL_EXPECTED = PACKAGE / "assets" / "eval_expected.json"
# the eval phases' sizes: lines per charset, pages per e2e row, noisy
# forms per extraction row, "Key: Value" documents, forms through the
# engine and the extractor, squiggle forms
EVAL_SIZES = {"lines": 100, "pages": 6, "forms": 25, "docs": 20, "forms_e2e": 4,
              "signatures": 4}
EVAL_PHASES = ("eval_rec", "eval_e2e_hybrid", "eval_e2e_classical", "eval_e2e_hindi",
               "eval_extract", "eval_forms_e2e", "eval_signatures")
# the engines the e2e rows score, as training/sweep_quality.py builds them
EVAL_ENGINE = {"det_image_buckets": (960,), "det_prob_wire_bits": 4}
# float32: where every rendered line and page has the record's digest,
# items equal on this share, every CER within EVAL_CER_TOL and every rate
# or F1 within EVAL_RATE_TOL of the record, every count equal; where the
# pixels differ, no worse than the record by more than EVAL_QUALITY_CER /
# EVAL_QUALITY_RATE
EVAL_ITEM_SHARE = 0.98
EVAL_CER_TOL = 0.005
EVAL_RATE_TOL = 0.01
EVAL_QUALITY_CER = 0.02
EVAL_QUALITY_RATE = 0.05
EVAL_COUNTS = ("n_lines", "n_pages", "n_docs", "repair_changed_pairs", "total_truth_pairs")
# the detector settings of the det_settings phase, each on the served
# hybrid engine at float32; the enhance kernel serves all but the last two
DET_SETTINGS = {
    "prob_wire_1": {"det_prob_wire_bits": 1},
    "prob_wire_4": {"det_prob_wire_bits": 4},
    "prob_wire_8": {"det_prob_wire_bits": 8},
    "wire_2": {"det_wire_bits": 2},
    "wire_8": {"det_wire_bits": 8},
    "contrast_off": {"enable_contrast_enhancement": False},
    "binarize": {"enable_adaptive_binarization": True},
}
DET_SETTINGS_PLAIN = ("contrast_off", "binarize")
DET_SETTINGS_FORMS = 4


def pixels_digest(a) -> str:
    """sha256 of an array's dtype, shape and bytes."""
    import hashlib

    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype}:{a.shape}:".encode() + a.tobytes()).hexdigest()


def det_settings_record(out) -> dict:
    """A page of the det_settings phase: its words (polygons to 0.01 px)
    and the states of its selection marks and its handwriting boxes, the
    parts of ``page_record`` that ``compare_to_expected`` reads."""
    rec = page_record(out)
    for w in rec["word"]:
        w["polygon"] = [round(v, 2) for v in w["polygon"]]
    return {"word": rec["word"], "selection_mark": [{"state": m["state"]}
                                                    for m in rec["selection_mark"]],
            "handwriting": [{"polygon": [round(v, 2) for v in h["polygon"]]}
                            for h in rec["handwriting"]]}


def eval_page_item(out) -> dict:
    """A page's evaluated output: its markdown and handwriting boxes."""
    return {"markdown": out.markdown,
            "handwriting": [[round(float(v), 2) for v in b["polygon"]]
                            for b in out.layout_boxes if b.get("type") == "handwriting"]}


def eval_fields_item(result) -> dict:
    return {"form_type": result.form_type,
            "fields": [[f.field_key, f.field_value] for f in result.fields]}


class Recorder:
    """Wraps a recognizer, an engine or an extractor of either package for
    the evaluation functions (training/evaluate.py) and records a digest of
    each rendered line or page it is given (``digests``) and each item's
    output (``items``: a line's text, ``eval_page_item``,
    ``eval_fields_item``). Every other attribute passes through, so
    ``hasattr`` tells a layout extractor from a text one as unwrapped."""

    def __init__(self, inner):
        self._inner = inner
        self.items: list = []
        self.digests: list[str] = []

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name == "recognize_page":
            return self._recognize_page
        if name == "process_pages":
            return self._process_pages
        if name in ("extract_from_layout", "extract"):
            return self._fields(attr)
        return attr

    def _recognize_page(self, page, quads):
        self.digests.append(pixels_digest(page))
        out = self._inner.recognize_page(page, quads)
        self.items.append(out[0].text)
        return out

    def _process_pages(self, pages):
        self.digests.extend(pixels_digest(p.pixels) for p in pages)
        outs = self._inner.process_pages(pages)
        self.items.extend(eval_page_item(o) for o in outs)
        return outs

    def _fields(self, fn):
        def call(*args, **kwargs):
            result = fn(*args, **kwargs)
            self.items.append(eval_fields_item(result))
            return result
        return call

    def record(self, result) -> dict:
        import dataclasses

        if dataclasses.is_dataclass(result):
            result = dataclasses.asdict(result)
        return {"result": json.loads(json.dumps(result)), "items": self.items,
                "digests": self.digests}


def eval_kit(device, dtype: str, **engine) -> dict:
    """The port's side of ``run_eval`` at ``dtype`` on the trained weights:
    training/evaluate, the charsets and recognizers, the hybrid and
    classical engines as training/sweep_quality.py builds them
    (EVAL_ENGINE, updated by ``engine``), the layout extractor and the rule
    extractor."""
    from ocr_system_tpu_torch.engine.recognizer import Recognizer
    from ocr_system_tpu_torch.extract.layout_model import LayoutModelExtractor
    from ocr_system_tpu_torch.extract.rules import RuleExtractor
    from ocr_system_tpu_torch.models.charsets import get_charset
    from ocr_system_tpu_torch.training import evaluate
    from ocr_system_tpu_torch.training.run_evaluate import build_engine
    from ocr_system_tpu_torch.training.synth_forms_heldout import HeldoutFormGenerator

    charsets = {cs: get_charset(cs) for cs in ("latin", "devanagari")}
    rec = {cs: Recognizer(Settings(rec_checkpoint=str(PACKAGE / "weights" / f"rec_{cs}.npz"),
                                   storage_root="storage", compute_dtype=dtype),
                          charset=charsets[cs], device=device)
           for cs in charsets}
    st = Settings(**TRAINED, storage_root="storage", compute_dtype=dtype,
                  **{**EVAL_ENGINE, **engine})
    engines = {kind: build_engine(kind, st, charsets["latin"], device)
               for kind in ("hybrid", "classical")}
    return {"E": evaluate, "heldout": HeldoutFormGenerator, "charsets": charsets, "rec": rec,
            "engines": engines, "rules": RuleExtractor(),
            "extractor": LayoutModelExtractor(Settings(compute_dtype=dtype), device=device)}


EVAL_RENDERS = PACKAGE / "assets" / "eval_renders.npz"


def _u8(image: np.ndarray) -> np.ndarray:
    return (image * 255).astype(np.uint8)


class RenderLog:
    """Records what either package's renderers draw while it is entered:
    ``TextRenderer.render_line`` and ``render_page`` of ``synth`` and
    ``render_spec`` of ``synth_forms`` (the modules of one package). Each
    event: its kind, the u8 image, and what the evaluations read besides
    (a line's text and width; a page's quads and texts; a rendered spec's
    element boxes and dropped pairs)."""

    def __init__(self, synth, synth_forms):
        self.modules = synth, synth_forms
        self.events: list[dict] = []

    def __enter__(self):
        synth, forms = self.modules
        cls = synth.TextRenderer
        self.saved = (cls.render_line, cls.render_page, forms.render_spec)
        line, page, spec_fn = self.saved
        log = self.events

        def render_line(renderer, *args, **kwargs):
            s = line(renderer, *args, **kwargs)
            log.append({"kind": "line", "image": _u8(s.image), "text": s.text,
                        "width": int(s.width)})
            return s

        def render_page(renderer, *args, **kwargs):
            s = page(renderer, *args, **kwargs)
            log.append({"kind": "page", "image": _u8(s.image), "quads": s.quads,
                        "texts": list(s.texts)})
            return s

        def render_spec(spec, *args, **kwargs):
            s = spec_fn(spec, *args, **kwargs)
            log.append({"kind": "spec", "image": _u8(s.image), "quads": s.quads,
                        "texts": list(s.texts),
                        "elements": [[e.text, e.x0, e.y0, e.x1, e.y1] for e in spec.elements],
                        "dropped": sorted(spec.dropped_pair_ids)})
            return s

        cls.render_line, cls.render_page, forms.render_spec = render_line, render_page, render_spec
        return self

    def __exit__(self, *exc):
        synth, forms = self.modules
        cls = synth.TextRenderer
        cls.render_line, cls.render_page, forms.render_spec = self.saved


def save_renders(logs: dict[str, list[dict]]) -> tuple[dict, dict[str, np.ndarray]]:
    """Render logs by phase -> (JSON-able events with each image, quads
    array named by key, the arrays by key; an image drawn twice is stored
    once)."""
    arrays: dict[str, np.ndarray] = {}
    out: dict[str, list[dict]] = {}
    for phase, events in logs.items():
        rows = out[phase] = []
        for i, ev in enumerate(events):
            row = {k: v for k, v in ev.items() if k not in ("image", "quads")}
            row["image"] = key = "img/" + pixels_digest(ev["image"])[:20]
            arrays[key] = ev["image"]
            if "quads" in ev:
                row["quads"] = f"quads/{phase}/{i}"
                arrays[row["quads"]] = np.asarray(ev["quads"], np.float32)
            rows.append(row)
    return out, arrays


class ReplayedRenders:
    """While entered, the port's renderers return the recorded events in
    their order instead of drawing (``save_renders``'s events and arrays):
    the pixels, and the geometry and texts measured from them, that the
    JAX package drew. The evaluations' random draws of what to draw still
    run (the specs, generated by pure Python, are checked against the
    record's element texts). A call out of order raises."""

    def __init__(self, events: list[dict], arrays):
        self.events, self.arrays, self.at = events, arrays, 0

    def _next(self, kind: str) -> dict:
        if self.at >= len(self.events) or self.events[self.at]["kind"] != kind:
            raise AssertionError(f"replay: {kind} render #{self.at} is not in the record")
        ev = self.events[self.at]
        self.at += 1
        return ev

    def _image(self, ev) -> np.ndarray:
        return self.arrays[ev["image"]].astype(np.float32) / 255.0

    def __enter__(self):
        from ocr_system_tpu_torch.training import synth, synth_forms

        cls = synth.TextRenderer
        self.saved = (cls.render_line, cls.render_page, synth_forms.render_spec)

        def render_line(renderer, *args, **kwargs):
            ev = self._next("line")
            return synth.LineSample(image=self._image(ev), text=ev["text"], width=ev["width"])

        def page_sample(ev):
            return synth.PageSample(image=self._image(ev), quads=self.arrays[ev["quads"]],
                                    texts=list(ev["texts"]), shrink_map=None,
                                    shrink_mask=None, thresh_map=None, thresh_mask=None)

        def render_page(renderer, *args, **kwargs):
            return page_sample(self._next("page"))

        def render_spec(spec, *args, **kwargs):
            ev = self._next("spec")
            if [e.text for e in spec.elements] != [row[0] for row in ev["elements"]]:
                raise AssertionError(f"replay: spec #{self.at - 1} is not the recorded one")
            for e, (_, x0, y0, x1, y1) in zip(spec.elements, ev["elements"]):
                e.x0, e.y0, e.x1, e.y1 = x0, y0, x1, y1
            spec.dropped_pair_ids.clear()
            spec.dropped_pair_ids.update(ev["dropped"])
            return page_sample(ev)

        cls.render_line, cls.render_page = render_line, render_page
        synth_forms.render_spec = render_spec
        return self

    def __exit__(self, *exc):
        from ocr_system_tpu_torch.training import synth, synth_forms

        cls = synth.TextRenderer
        cls.render_line, cls.render_page, synth_forms.render_spec = self.saved


def eval_renders() -> dict[str, np.ndarray]:
    with np.load(EVAL_RENDERS) as z:
        return {k: z[k] for k in z.files}


def run_eval(name: str, kit: dict, sizes: dict = EVAL_SIZES) -> dict[str, dict]:
    """One eval phase (EVAL_PHASES) with either package's evaluation
    module and models in ``kit``: "E" (training/evaluate), "heldout"
    (HeldoutFormGenerator), "charsets" and "rec" (by "latin" and
    "devanagari"), "engines" ("hybrid", "classical"), "extractor" (the
    layout model) and "rules" (the rule extractor). Returns each run's
    ``Recorder.record``, by run."""
    E = kit["E"]
    runs = {}
    if name == "eval_rec":
        for cs in ("latin", "devanagari"):
            r = Recorder(kit["rec"][cs])
            runs[cs] = r.record(E.evaluate_recognizer(r, kit["charsets"][cs],
                                                      n_lines=sizes["lines"]))
    elif name.startswith("eval_e2e_"):
        r = Recorder(kit["engines"]["classical" if name.endswith("classical") else "hybrid"])
        cs = kit["charsets"]["devanagari" if name.endswith("hindi") else "latin"]
        runs["pages"] = r.record(E.evaluate_end_to_end(r, cs, n_pages=sizes["pages"]))
    elif name == "eval_extract":
        for run, kw in (("infamily", {}), ("heldout", {"generator": kit["heldout"](seed=101)})):
            r = Recorder(kit["extractor"])
            runs[run] = r.record(E.evaluate_form_extraction(r, n_docs=sizes["forms"], **kw))
        r = Recorder(kit["rules"])
        runs["field_rules"] = r.record(E.evaluate_field_extraction(r, n_docs=sizes["docs"]))
    elif name == "eval_forms_e2e":
        eng, ex = Recorder(kit["engines"]["hybrid"]), Recorder(kit["extractor"])
        runs["pages"] = eng.record(E.evaluate_form_extraction_e2e(
            eng, ex, n_docs=sizes["forms_e2e"]))
        runs["fields"] = ex.record({})
    elif name == "eval_signatures":
        r = Recorder(kit["engines"]["hybrid"])
        runs["pages"] = r.record(E.evaluate_signature_detection(r, n_docs=sizes["signatures"]))
    else:
        raise ValueError(f"unknown eval phase {name!r}")
    return runs


def _leaves(obj, path: str = ""):
    if isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, f"{path}/{k}" if path else k)
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        yield path, float(obj)


def same_item(a, b) -> bool:
    """Two recorded items alike: texts and fields equal; a page's markdown
    equal and its handwriting boxes each within 2 px."""
    if isinstance(a, dict) and "markdown" in a:
        return (a["markdown"] == b["markdown"]
                and len(a["handwriting"]) == len(b["handwriting"])
                and all(np.abs(np.subtract(p, q)).max() <= 2.0
                        for p, q in zip(a["handwriting"], b["handwriting"])))
    return a == b


def compare_eval(want: dict[str, dict], got: dict[str, dict], gate: bool) -> dict:
    """An eval phase's runs against the record's: whether every digest is
    equal, the share of items alike, each aggregate's deviation, and with
    ``gate`` the misses of the float32 bar (EVAL_* above): the exact bar
    where the pixels are the record's, the quality bar where they are
    not."""
    out: dict = {"runs": {}, "misses": []}
    for run, w in want.items():
        g = got[run]
        digests_equal = w["digests"] == g["digests"]
        alike = [same_item(a, b) for a, b in zip(w["items"], g["items"], strict=True)]
        share = sum(alike) / max(len(alike), 1)
        want_r, got_r = dict(_leaves(w["result"])), dict(_leaves(g["result"]))
        dev = {k: got_r[k] - v for k, v in want_r.items()}
        out["runs"][run] = {
            "digests_equal": digests_equal,
            "pixels_differ": sum(a != b for a, b in zip(w["digests"], g["digests"])),
            "items": len(alike), "items_alike": share,
            "result": got_r, "deviation": dev,
        }
        if not gate:
            continue
        tag = f"{run}: "
        for k, d in dev.items():
            leaf = k.rsplit("/", 1)[-1]
            if leaf in EVAL_COUNTS:
                if d != 0:
                    out["misses"].append(tag + f"{k} {got_r[k]} != {want_r[k]}")
            elif digests_equal:
                tol = EVAL_CER_TOL if "cer" in leaf else EVAL_RATE_TOL
                if abs(d) > tol:
                    out["misses"].append(tag + f"{k} off by {d:+.4f} (bar {tol})")
            elif "cer" in leaf and d > EVAL_QUALITY_CER:
                out["misses"].append(tag + f"{k} worse by {d:+.4f} (bar {EVAL_QUALITY_CER})")
            elif "cer" not in leaf and d < -EVAL_QUALITY_RATE:
                out["misses"].append(tag + f"{k} worse by {d:+.4f} (bar {EVAL_QUALITY_RATE})")
        if digests_equal and share < EVAL_ITEM_SHARE:
            out["misses"].append(tag + f"items alike {share:.3f} < {EVAL_ITEM_SHARE}")
    return out


def eval_expected() -> dict:
    return json.loads(EVAL_EXPECTED.read_text())
