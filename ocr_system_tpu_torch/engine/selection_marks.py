"""Selection-mark (checkbox) detection: geometric CC analysis on the host
(port of ocr_system_tpu/engine/selection_marks.py, its cv2 branch), and
the pairing of marks with their labels into checkbox fields
(``marks_to_fields``).

  ink mask (adaptive MEAN threshold) -> connected components in OpenCV's
  label order -> near-square, box-sized components with high BORDER
  coverage and low interior fill -> selection marks; interior ink
  fraction decides selected/unselected.

Marks come out in component order, so the labeling keeps OpenCV's order
(``native/cc_label.label_cv2``).
"""

from __future__ import annotations

import numpy as np

from ocr_system_tpu_torch.engine.host_image import adaptive_threshold, rgb_to_gray
from ocr_system_tpu_torch.native import cc_label

# geometry gates, in units of the component bounding box
MIN_SIDE_PX = 8          # smaller than this: speckle / glyph dots
MAX_SIDE_PX = 64         # larger: framed images, table cells
MAX_ASPECT = 1.45        # |w/h| and |h/w| must stay under this
MIN_BORDER_COVER = 0.75  # fraction of each side's pixels that must be ink
MAX_SOLID_FILL = 0.85    # fully solid blobs are bullets, not checkboxes
CHECKED_MIN_FILL = 0.12  # interior ink fraction that means "selected"


def _ink_mask(page: np.ndarray) -> np.ndarray:
    """(H, W) luma or (H, W, 3) RGB uint8 -> 1 = ink, by the adaptive MEAN
    threshold (block 31, C 15)."""
    return adaptive_threshold(rgb_to_gray(page), "mean", 31, 15)


def _components(mask: np.ndarray):
    """-> (labels, n, bboxes[n+1, 4] as x0,y0,x1,y1 inclusive), labels in
    OpenCV's order."""
    labels, n = cc_label.label_cv2(mask)
    _, bboxes = cc_label.stats(labels, n)
    return labels, n, bboxes


def page_components(page: np.ndarray):
    """Shared ink mask + connected components for the host post-passes
    (selection marks and handwriting read the same labeling; the det stage
    computes it once per page into ``DetResult.cc``)."""
    mask = _ink_mask(np.ascontiguousarray(page))
    labels, n, bboxes = _components(mask)
    return mask, labels, n, bboxes


def detect_selection_marks(
    page: np.ndarray, page_number: int = 1, cc=None
) -> list[dict]:
    """page: (H, W[, 3]) uint8 -> Azure-shaped selection_mark layout boxes.
    cc: optional precomputed page_components(page) tuple."""
    mask, labels, n, bboxes = cc if cc is not None else page_components(page)
    marks: list[dict] = []
    for comp in range(1, n + 1):
        x0, y0, x1, y1 = (int(v) for v in bboxes[comp])
        w, h = x1 - x0 + 1, y1 - y0 + 1
        if not (MIN_SIDE_PX <= w <= MAX_SIDE_PX
                and MIN_SIDE_PX <= h <= MAX_SIDE_PX):
            continue
        if max(w / h, h / w) > MAX_ASPECT:
            continue
        comp_mask = labels[y0: y1 + 1, x0: x1 + 1] == comp
        fill = float(comp_mask.mean())
        if fill > MAX_SOLID_FILL:
            continue  # solid bullet/blob
        # border coverage: every one of the 4 sides must be mostly ink.
        # 2-px bands tolerate 1-px raster jitter in the outline.
        band = 2 if min(w, h) >= 12 else 1
        top = comp_mask[:band, :].any(axis=0).mean()
        bottom = comp_mask[-band:, :].any(axis=0).mean()
        left = comp_mask[:, :band].any(axis=1).mean()
        right = comp_mask[:, -band:].any(axis=1).mean()
        side_cover = min(top, bottom, left, right)
        if side_cover < MIN_BORDER_COVER:
            continue
        # interior fill decides the state, on the FULL ink mask: a stroke
        # touching the outline is part of the component, a floating tick
        # is its own component
        iy0, iy1 = y0 + band + 1, y1 - band
        ix0, ix1 = x0 + band + 1, x1 - band
        if iy1 <= iy0 or ix1 <= ix0:
            continue
        interior = mask[iy0:iy1, ix0:ix1]
        interior_fill = float(interior.mean())
        selected = interior_fill >= CHECKED_MIN_FILL
        # confidence: border closure plus how decisive the interior is
        decisive = min(abs(interior_fill - CHECKED_MIN_FILL) / 0.1, 1.0)
        conf = round(float(min(0.55 + 0.3 * side_cover + 0.15 * decisive,
                               0.99)), 4)
        marks.append(
            {
                "type": "selection_mark",
                "state": "selected" if selected else "unselected",
                "content": "",
                "confidence": conf,
                "polygon": [
                    float(x0), float(y0), float(x1 + 1), float(y0),
                    float(x1 + 1), float(y1 + 1), float(x0), float(y1 + 1),
                ],
                "page_number": page_number,
            }
        )
    return marks


def marks_to_fields(marks: list[dict], layout_boxes: list[dict]) -> list[dict]:
    """Pair each selection mark with its text label -> checkbox field dicts
    `{"field_key", "field_value" ("yes"/"no"), "field_type": "checkbox",
    "confidence", "page_number"}` — what the reference's Gemini emits when it
    reads '☑ Male' (and validate_checkbox accepts, validation_service
    CHECKBOX_VALUES). Label = nearest same-row word run, preferring text to
    the RIGHT of the mark (the dominant forms convention: '[x] Option')."""
    words = [b for b in layout_boxes
             if b.get("type") == "word" and b.get("content", "").strip()]
    fields: list[dict] = []
    for m in marks:
        mx = m["polygon"][0::2]
        my = m["polygon"][1::2]
        m_x0, m_x1 = min(mx), max(mx)
        m_yc = (min(my) + max(my)) / 2.0
        m_h = max(max(my) - min(my), 1.0)
        same_row = [
            w for w in words
            if w.get("page_number") == m.get("page_number")
            and abs((min(w["polygon"][1::2]) + max(w["polygon"][1::2])) / 2.0
                    - m_yc) < m_h * 1.2
        ]
        if not same_row:
            continue

        def gap(w):
            wx = w["polygon"][0::2]
            left_gap = min(wx) - m_x1       # text to the right of the mark
            right_gap = m_x0 - max(wx)      # text to the left of the mark
            if left_gap >= 0:
                return left_gap             # prefer right-side labels
            if right_gap >= 0:
                return right_gap + m_h * 2  # left-side: pay a small penalty
            return m_h * 10                 # overlapping text: last resort

        nearest = min(same_row, key=gap)
        if gap(nearest) > m_h * 8:
            continue  # nothing plausibly labels this mark
        # extend the label along contiguous words on the same side
        direction = 1 if min(nearest["polygon"][0::2]) >= m_x1 else -1
        run = [nearest]
        candidates = sorted(
            (w for w in same_row if w is not nearest),
            key=lambda w: min(w["polygon"][0::2]),
        )
        if direction < 0:
            candidates = candidates[::-1]
        edge = (max if direction > 0 else min)(run[0]["polygon"][0::2])
        for w in candidates:
            wx0, wx1 = min(w["polygon"][0::2]), max(w["polygon"][0::2])
            if direction > 0 and 0 <= wx0 - edge <= m_h * 1.5:
                run.append(w)
                edge = wx1
            elif direction < 0 and 0 <= edge - wx1 <= m_h * 1.5:
                run.insert(0, w)
                edge = wx0
        label = " ".join(w["content"] for w in run).strip().rstrip(":")
        if not label:
            continue
        fields.append(
            {
                "field_key": label,
                "field_value": "yes" if m["state"] == "selected" else "no",
                "field_type": "checkbox",
                "confidence": m["confidence"],
                "page_number": m.get("page_number", 1),
            }
        )
    return fields


def filter_marks_against_words(
    marks: list[dict], word_boxes: list[dict], max_overlap: float = 0.3
) -> list[dict]:
    """Drop marks that sit mostly inside recognized TEXT (glyphs like 'O',
    'D' or table-cell digits can survive the geometry gates). A mark
    legitimately overlaps the text box of its label, so only high overlap
    with a box that actually decoded text disqualifies it."""
    out = []
    for m in marks:
        mx = m["polygon"][0::2]
        my = m["polygon"][1::2]
        m_area = max((mx[2] - mx[0]) * (my[2] - my[0]), 1e-6)
        keep = True
        for wb in word_boxes:
            if wb.get("type") != "word" or not wb.get("content", "").strip():
                continue
            wx = wb["polygon"][0::2]
            wy = wb["polygon"][1::2]
            ix = min(max(mx), max(wx)) - max(min(mx), min(wx))
            iy = min(max(my), max(wy)) - max(min(my), min(wy))
            if ix > 0 and iy > 0 and (ix * iy) / m_area > max_overlap:
                keep = False
                break
        if keep:
            out.append(m)
    return out
