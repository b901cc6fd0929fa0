"""Handwriting / signature region detection from pixels, and the pairing
of the regions with their labels into signature fields
(``handwriting_to_fields``, merged by ``squiggle_overrides``) (port of
ocr_system_tpu/engine/handwriting.py).

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
"page_number"}`` layout boxes, in component order; the orchestrator pairs them with
signature-keyword labels into ``signature`` fields (value "signed") that
the signature validator accepts.
"""

from __future__ import annotations

import unicodedata

import numpy as np

from ocr_system_tpu_torch.engine.selection_marks import page_components
from ocr_system_tpu_torch.extract.postfix import _cer, clean_key

MIN_W = 40
MIN_H = 12
MAX_ASPECT = 15.0
MIN_ASPECT = 1.2
MIN_FILL = 0.015
MAX_FILL = 0.45
# line-likeness: fraction of ink captured by the densest 3 rows (or cols)
MAX_PROFILE_CONC = 0.75

SIGNATURE_KEYWORDS = (
    "signature", "signed", "sign here", "initials", "authorised by",
    "authorized by", "हस्ताक्षर",
)


def _has_signature_keyword(content: str) -> bool:
    """Substring match plus a FUZZY token match for the long keywords:
    rec noise on the label itself ('Signoturo') must not demote a true
    signature label to the nearest-label fallback, which can then drift
    to a neighboring VALUE word (measured: seed-6260 doc 4, 'Signature'
    squiggle labeled 'item monthly')."""
    if any(k in content for k in SIGNATURE_KEYWORDS):
        return True
    tokens = [t for t in content.split() if len(t) >= 6]
    return any(
        _cer(k, t) <= 0.25
        for t in tokens
        for k in ("signature", "initials", "authorised", "authorized")
    )


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


def squiggle_overrides(
    sf: dict,
    existing_value: str | None,
    existing_conf: float = 1.0,
    other_keys: set[str] | frozenset[str] = frozenset(),
) -> bool:
    """Merge policy for a squiggle field vs an extractor pair on the same
    key — the ONE decision shared by serving (orchestrator) and both eval
    paths, so they cannot drift (ADVICE r3):

    - no existing value: fill.
    - keyword label ('Signature:'): override unless the existing value
      reads as clean printed text (a real printed name/date under the
      label survives — ADVICE r3).
    - nearest-label guess: override only when the squiggle is glued to its
      label (label_gap <= 1.5 label heights) AND the existing value is
      either soup or a fragment of ANOTHER extracted key (the extractor
      stole the next label's words — diag r4 'window: Tizolu' family). A
      genuine printed value never matches a neighboring key, so it
      survives even when handwriting detection false-positives next to
      its label (diag r4 doc 9: a matra cluster adjacent to a label whose
      true value '314540' sat farther right). Unconditional override was
      measured in r3 to destroy true Devanagari fields.
    """
    if existing_value is None or not existing_value.strip():
        return True
    if sf.get("keyword_label"):
        return not _is_clean_text(existing_value, existing_conf)
    if float(sf.get("label_gap", 99.0)) > 1.5:
        return False
    if not _is_clean_text(existing_value, existing_conf):
        return True
    v = " ".join(existing_value.lower().split())
    own = " ".join(str(sf.get("field_key", "")).lower().split())
    return any(
        k != own and (v in k or k in v) for k in other_keys if k.strip()
    )


def handwriting_to_fields(
    hand_boxes: list[dict], layout_boxes: list[dict]
) -> list[dict]:
    """Pair signature-keyword labels with nearby handwriting boxes ->
    signature field dicts (value "signed", accepted by validate_signature).
    Search: for each label word run containing a keyword, a handwriting box
    to its right on the same row, or below it, within ~3 label heights."""
    words = [b for b in layout_boxes
             if b.get("type") in ("word", "line")
             and b.get("content", "").strip()]
    fields: list[dict] = []
    used: set[int] = set()
    for wb in words:
        content = wb["content"].strip().lower()
        if not _has_signature_keyword(content):
            continue
        wx = wb["polygon"][0::2]
        wy = wb["polygon"][1::2]
        w_x0, w_x1 = min(wx), max(wx)
        w_y0, w_y1 = min(wy), max(wy)
        w_h = max(w_y1 - w_y0, 1.0)
        best = None
        best_d = None
        for i, hb in enumerate(hand_boxes):
            if i in used or hb.get("page_number") != wb.get("page_number"):
                continue
            hx = hb["polygon"][0::2]
            hy = hb["polygon"][1::2]
            h_x0, h_y0 = min(hx), min(hy)
            h_yc = (min(hy) + max(hy)) / 2.0
            same_row = abs(h_yc - (w_y0 + w_y1) / 2.0) < w_h * 1.5
            right_d = h_x0 - w_x1
            below = h_y0 - w_y1
            if same_row and -w_h <= right_d <= w_h * 20:
                d = max(right_d, 0.0)
            elif (
                -w_h * 2 <= below <= w_h * 3.5
                # under the label, not off to its left: a y-overlapping
                # label RIGHT of the squiggle used to win here at d=w_h
                # and beat the true same-row label (diag r4 doc 5)
                and w_x0 - w_h <= h_x0 < w_x1 + w_h * 20
            ):
                d = max(below, 0.0) + w_h  # below: small penalty
            else:
                continue
            if best_d is None or d < best_d:
                best, best_d = i, d
        if best is None:
            continue
        used.add(best)
        key = clean_key(wb["content"])
        fields.append(
            {
                "field_key": key,
                "field_value": "signed",
                "field_type": "signature",
                "confidence": hand_boxes[best]["confidence"],
                "page_number": wb.get("page_number", 1),
                # explicit signature keyword: strong enough to OVERRIDE an
                # extractor pair for the same key downstream
                "keyword_label": True,
            }
        )
    # second pass: a pixel-verified squiggle with NO keyword label still
    # belongs to its nearest label — forms label signature lines with
    # arbitrary keys ('Authorised', a name, a custom field), and the
    # reference's extractor pairs by layout, not by keyword
    # (gemini_service.py:235-364 sees the squiggle next to its label).
    # The box itself is the evidence; the label just names the field.
    # trailing-colon label runs ('Position:'): anything sitting just right
    # of one on the same row is that label's VALUE, not a free label
    colon_labels = []
    for wb in words:
        txt = wb["content"].strip()
        if txt.endswith(":"):
            xs_, ys_ = wb["polygon"][0::2], wb["polygon"][1::2]
            colon_labels.append(
                (wb.get("page_number"), max(xs_), min(ys_), max(ys_))
            )

    def _is_value_of_colon_label(wb) -> bool:
        wx = wb["polygon"][0::2]
        wy = wb["polygon"][1::2]
        w_x0 = min(wx)
        w_yc = (min(wy) + max(wy)) / 2.0
        w_h = max(max(wy) - min(wy), 1.0)
        for pg, lx1, ly0, ly1 in colon_labels:
            if pg != wb.get("page_number"):
                continue
            if ly0 - 0.3 * w_h <= w_yc <= ly1 + 0.3 * w_h and (
                -0.5 * w_h <= w_x0 - lx1 <= 4.0 * w_h
            ):
                return True
        return False

    for i, hb in enumerate(hand_boxes):
        if i in used:
            continue
        hx = hb["polygon"][0::2]
        hy = hb["polygon"][1::2]
        h_x0, h_y0 = min(hx), min(hy)
        h_yc = (min(hy) + max(hy)) / 2.0
        best_wb = None
        best_d = None
        for wb in words:
            if hb.get("page_number") != wb.get("page_number"):
                continue
            # a run that already carries an inline value ('तोनीह: 2009-04-15',
            # 'lenu mark: carlos olsen') is a COMPLETE field, not a label
            # awaiting a signature — pairing the squiggle to it both fabricates
            # a field and orphans the true label (measured on forms_e2e)
            txt = wb["content"].strip()
            cp = txt.find(":")
            if 0 <= cp < len(txt) - 1 and txt[cp + 1:].strip():
                continue
            # VALUE-shaped runs are not labels: digit-dominant text (a
            # phone/date/amount box) or a long det row-merge (>5 tokens)
            # paired a squiggle into a fabricated field (diag r4 doc 5:
            # squiggle -> '(919) 214-5410' and a whole merged row)
            n_digits = sum(c.isdigit() for c in txt)
            if n_digits > 0.4 * max(len(txt.replace(" ", "")), 1):
                continue
            if len(txt.split()) > 5 or "@" in txt:
                continue
            # sitting right of a 'Key:' run on the same row -> it's that
            # key's value ('Position:' | 'item monthly' | squiggle below:
            # the squiggle must not steal 'item monthly' as its label —
            # measured seed-6260 doc 4, fabricated pair + orphaned truth)
            if _is_value_of_colon_label(wb):
                continue
            # (measured, rejected: also skipping labels with any printed
            # same-row right neighbor — multi-word labels get skipped and
            # the pairing falls through to VALUE words, 35/8 -> 35/10
            # exact/spurious on the forms_e2e diagnostic)
            wx = wb["polygon"][0::2]
            wy = wb["polygon"][1::2]
            w_x0, w_x1 = min(wx), max(wx)
            w_y0, w_y1 = min(wy), max(wy)
            w_h = max(w_y1 - w_y0, 1.0)
            same_row = abs(h_yc - (w_y0 + w_y1) / 2.0) < w_h * 1.5
            right_d = h_x0 - w_x1
            below = h_y0 - w_y1
            if same_row and -w_h <= right_d <= w_h * 10:
                d = max(right_d, 0.0)
            elif (
                -w_h * 2 <= below <= w_h * 3.0
                # same under-the-label constraint as the keyword pass
                and w_x0 - w_h <= h_x0 < w_x1 + w_h * 10
            ):
                d = max(below, 0.0) + w_h
            else:
                continue
            if best_d is None or d < best_d:
                best_wb, best_d = wb, d
        if best_wb is None:
            continue
        used.add(i)
        # label word runs often end with the key's last word; take the
        # trailing "Key:"-like text (strip a value if the run merged one)
        key = clean_key(best_wb["content"])
        w_h = max(
            max(best_wb["polygon"][1::2]) - min(best_wb["polygon"][1::2]),
            1.0,
        )
        fields.append(
            {
                "field_key": key,
                "field_value": "signed",
                "field_type": "signature",
                "confidence": round(hb["confidence"] * 0.8, 4),
                "page_number": best_wb.get("page_number", 1),
                # nearest-label guess: fills a missing field downstream but
                # must NOT override an extractor pair for the same key —
                # UNLESS the squiggle hugs the label (label_gap, in label
                # heights): nothing printed can fit between them, so a
                # same-key extractor pair must be misassigned distant text
                "keyword_label": False,
                "label_gap": round(float(best_d) / w_h, 3),
            }
        )
    return fields
