"""Handwriting / signature region detection from pixels (port of
ocr_system_tpu/engine/handwriting.py; pairing the regions with their
labels, ``handwriting_to_fields`` and ``squiggle_overrides``, belongs to
extraction, a later slice).

Host-side geometric pass on the page components that selection marks
share (``selection_marks.page_components``): components that are
ink-sparse, not line-like, and not covered by a box that decoded as clean
printed text are handwriting regions.

What distinguishes a squiggle from everything else on a form page:
  - printed TEXT is covered by recognized word boxes (they veto it),
  - ruled LINES / table grids concentrate their ink in a few rows/columns
    (profile concentration test),
  - solid logos / stamps have high fill,
  - a signature stroke is sparse (2-px pen over a wide box), spread across
    rows, wider than tall.

Emits ``{"type": "handwriting", "content": "", "confidence", "polygon",
"page_number"}`` layout boxes, in component order.
"""

from __future__ import annotations

import unicodedata

import numpy as np

from ocr_system_tpu_torch.engine.selection_marks import page_components

MIN_W = 40
MIN_H = 12
MAX_ASPECT = 15.0
MIN_ASPECT = 1.2
MIN_FILL = 0.015
MAX_FILL = 0.45
# line-likeness: fraction of ink captured by the densest 3 rows (or cols)
MAX_PROFILE_CONC = 0.75


def _is_clean_text(
    content: str,
    confidence: float,
    box_w: float | None = None,
    box_h: float | None = None,
) -> bool:
    """A decode that reads like real printed text: squiggles come back as
    short symbol soup ('Y4', '\\W^M') even at high confidence, while
    printed words decode to alnum-dominated strings. Combining marks
    (Mn/Mc) count as letters: Indic matras are real text, and a printed
    Devanagari header is exactly the kind of wide shirorekha-connected
    component the CC shape test mistakes for a pen stroke.

    When box geometry is given, the decode must also be DENSE enough for
    print: a recognizer robust to artifacts decodes a squiggle to short
    alnum soup ('2Aucr' at conf 0.69 for a 200px-wide stroke), but print
    at that width would yield ~box_w / (0.6 * box_h) characters — a
    decode under a third of that is pen, not type (round-3 regression:
    the rule-artifact rec fine-tune un-souped squiggle decodes and the
    alnum test alone started vetoing real signatures)."""
    t = content.strip()
    # 0.78: print decodes at 0.9+, squiggles at 0.6-0.8 even when the
    # robust rec maps them to alnum soup ('2Aucr' at 0.69). The old 0.5
    # gate predates the rule-artifact fine-tune that un-souped squiggles.
    if len(t) < 3 or confidence < 0.78:
        return False
    # friendly set includes common form punctuation — '(Rev)', '#12',
    # 'Q&A', "O'Brien" are real short print, and the 100% requirement for
    # len<=5 strings would otherwise veto them (ADVICE r3: vetoed words
    # near a stroke-shaped component vanish from markdown entirely)
    alnum = sum(
        c.isalnum()
        or c in " .,:/-$%()#&'\""
        or unicodedata.category(c) in ("Mn", "Mc")
        for c in t
    )
    # short decodes: one soup char in 4-5 chars is strong evidence
    # ('\\/W,' hits alnum 0.75 and used to pass) — real short print
    # ('Date', '12/31', 'A-1') is all-friendly. Long strings keep the
    # 0.7 ratio so one stray glyph can't flip a sentence.
    if alnum / len(t) < (1.0 if len(t) <= 5 else 0.7):
        return False
    if box_w and box_h and box_h > 0:
        expected = box_w / (0.6 * box_h)
        if len(t) < 0.3 * expected:
            return False
    return True


def detect_handwriting(
    page: np.ndarray,
    word_boxes: list[dict],
    page_number: int = 1,
    max_dim: int = 64,
    cc=None,
) -> list[dict]:
    """page: (H, W[, 3]) uint8; word_boxes: recognized TEXT boxes (used to
    veto candidates that decode as clean printed text).
    -> handwriting layout boxes.

    No dilation and no pre-subtraction: a pen stroke is self-connected
    (one wide component), while printed letters stay separate small
    components below MIN_W — and the recognizer decodes a squiggle region
    to symbol soup, so a clean confident decode vetoes a candidate
    afterwards (an OOD squiggle can decode with conf ~0.8, which is why
    confidence alone cannot gate)."""
    if cc is None:
        cc = page_components(page)
    raw, labels, n, bboxes = cc
    h, w = raw.shape
    marks: list[dict] = []
    page_diag = max(h, w)
    for comp in range(1, n + 1):
        x0, y0, x1, y1 = (int(v) for v in bboxes[comp])
        cw, ch = x1 - x0 + 1, y1 - y0 + 1
        if cw < MIN_W or ch < MIN_H or ch > page_diag // 4:
            continue
        aspect = cw / ch
        if not (MIN_ASPECT <= aspect <= MAX_ASPECT):
            continue
        comp_mask = labels[y0: y1 + 1, x0: x1 + 1] == comp
        ink = raw[y0: y1 + 1, x0: x1 + 1].astype(bool) & comp_mask
        total = int(ink.sum())
        fill = total / max(cw * ch, 1)
        if not (MIN_FILL <= fill <= MAX_FILL) or total < 60:
            continue
        # line/grid rejection, two tests:
        # (a) ink concentrated in a few rows/cols (single rules),
        # (b) most ink lying on full-span rows/cols (ruled table grids —
        #     each grid line individually is a near-full-width row or
        #     near-full-height column of ink)
        rows = ink.sum(axis=1).astype(np.float64)
        cols = ink.sum(axis=0).astype(np.float64)
        row_conc = float(np.sort(rows)[-3:].sum() / max(total, 1))
        col_conc = float(np.sort(cols)[-3:].sum() / max(total, 1))
        if row_conc > MAX_PROFILE_CONC or col_conc > MAX_PROFILE_CONC:
            continue
        line_mass = float(rows[rows >= 0.8 * cw].sum()
                          + cols[cols >= 0.8 * ch].sum())
        if line_mass / max(total, 1) > 0.6:
            continue
        # stroke must span a healthy share of its rows (squiggles wander)
        if float((rows > 0).mean()) < 0.5:
            continue
        # veto: mostly covered by a box that decoded as clean printed text
        # (touching bold titles form wide components too)
        area = float(cw * ch)
        vetoed = False
        for wb in word_boxes:
            px = wb["polygon"][0::2]
            py = wb["polygon"][1::2]
            if wb.get("type") != "word" or not _is_clean_text(
                wb.get("content", ""), wb.get("confidence", 0.0),
                box_w=max(px) - min(px), box_h=max(py) - min(py),
            ):
                continue
            ix = min(x1 + 1, max(px)) - max(x0, min(px))
            iy = min(y1 + 1, max(py)) - max(y0, min(py))
            if ix > 0 and iy > 0 and (ix * iy) / area > 0.5:
                vetoed = True
                break
        if vetoed:
            continue
        conf = round(float(min(0.5 + (1.0 - row_conc) * 0.5, 0.95)), 4)
        marks.append(
            {
                "type": "handwriting",
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
