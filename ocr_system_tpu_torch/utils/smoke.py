"""The smoke workload of chip_smoke.py and utils/profile_wave.py: the
port's engines with the trained weights (``weights/*.npz``, written by
export_torch_weights.py), the committed Latin and Hindi synthetic forms
and glued-lines page and the JAX package's outputs on them (``assets/``),
and synthetic pages and checkboxes drawn with numpy from a seed; the
record and comparison of a page's layout, routing and rescues against
those outputs; the extraction documents built from those outputs and the
record and comparison of their fields, field rows and validation reports
against the JAX package's (``assets/extract_expected.json``); and the bf16
agreement rules that chip_smoke.py and the tests share."""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np
import torch

from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine.host_image import rgb_to_gray
from ocr_system_tpu_torch.engine.pipeline import TorchOCREngine, combine_markdown, get_engine

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
# dot leaders (rec_bf16_probe.py).
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
