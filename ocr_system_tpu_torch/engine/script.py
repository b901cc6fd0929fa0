"""Per-page script detection and Devanagari re-segmentation (port of
ocr_system_tpu/engine/script.py).

The recognizers are per charset, so the engine serves Latin and Hindi
pages on one endpoint with two host passes:

1. ``page_script``: classify a detected page as latin or devanagari, so
   the engine can route its crops to the matching recognizer. The feature
   is the shirorekha, the headline stroke along the top of Devanagari
   words: Latin text has no near-full-width horizontal ink run in its upper
   band; Devanagari words almost always do.

2. ``resegment_devanagari``: DBNet trained on Latin words both merges
   Devanagari words and splits them mid-conjunct. The repair is geometric:
   cluster det boxes into rows, merge same-row chains into line segments,
   then split each segment at the column-ink gaps that survive under the
   shirorekha (between words the headline breaks, within a word it fills
   every column).

Both run on host numpy over a handful of crops: control-flow-heavy tiny
work that stays off the device. Components are labelled in raster order
of their first pixel (``ops/boxes._label_components``), as the reference's
native op numbers them: the tie-breaking sorts below depend on it.
"""

from __future__ import annotations

import numpy as np

from ocr_system_tpu_torch.engine.host_image import rgb_to_gray
from ocr_system_tpu_torch.native import cc_label
from ocr_system_tpu_torch.ops.boxes import DetectedBox, _label_components
from ocr_system_tpu_torch.ops.sampling import axis_aligned_mask

# shirorekha detection: a row in the top band with a CONTIGUOUS ink run much
# wider than the glyph height. Contiguity separates it from Latin cap-tops
# ("TOTAL" has high row coverage but the run breaks at every letter gap).
# Measured margins (synthetic font vs DejaVu, sizes 14-30): Devanagari words
# score 1.5-2.4 x ink height (short 2-glyph words can drop below), Latin
# tops out at ~1.5 ("mm" bold). 1.55 splits them.
HEADLINE_MIN_RUN_X_HEIGHT = 1.55
HEADLINE_TOP_BAND = 0.55  # search the top 55% of box rows
HEADLINE_MIN_BELOW_SUPPORT = 0.06  # run columns with ink attached below
PAGE_DEVA_FRACTION = 0.45  # boxes with headlines needed to call a page Hindi
# absolute quorum: a sparse Latin page can have only 1-2 wide components
# (touching bold serif caps whose top serifs bridge into a headline-scale
# run), and one such false positive would flip the whole page. Measured
# over 40 mixed synthetic forms: Latin pages max 1 hit, Devanagari min 8.
PAGE_DEVA_MIN_HITS = 3

# re-segmentation produces LINE-level crops, not words: the recognizer
# scores CER 0.08 on whole truth lines vs 0.38 on word splits (measured in
# the reference), so only column-scale gaps split a merged chain.
LINE_SPLIT_GAP_RATIO = 1.1   # empty run >= this x ink height splits
WORD_GAP_RATIO = 0.18        # used only for aspect-forced splits
MAX_CROP_ASPECT = 12.0       # keep crops within the widest rec bucket
MERGE_GAP_RATIO = 0.35  # same-row boxes closer than this merge into a line


def _to_gray(page: np.ndarray) -> np.ndarray:
    """The reference's cv2 Rec.601 luma (bit for bit); 2D passes through."""
    return rgb_to_gray(page)


def _crop_aabb(gray: np.ndarray, quad: np.ndarray) -> np.ndarray:
    h, w = gray.shape
    x0 = int(np.clip(quad[:, 0].min(), 0, w - 1))
    x1 = int(np.clip(quad[:, 0].max() + 1, x0 + 1, w))
    y0 = int(np.clip(quad[:, 1].min(), 0, h - 1))
    y1 = int(np.clip(quad[:, 1].max() + 1, y0 + 1, h))
    return gray[y0:y1, x0:x1]


def _ink(crop: np.ndarray) -> np.ndarray:
    """Local binarization: ink = darker than the crop's bimodal midpoint.
    ``lo`` is the true min, not a low percentile: a wide sparse crop (a line
    with a large column gap) can hold <5% ink pixels, and a percentile floor
    would read it as blank."""
    if crop.size == 0:
        return np.zeros_like(crop)
    lo = float(crop.min())
    hi = float(np.percentile(crop, 90))
    if hi - lo < 25:  # blank-ish crop
        return np.zeros_like(crop, dtype=bool)
    return crop < (lo + hi) / 2.0


def _component_boxes(labels: np.ndarray, ink: np.ndarray, n: int):
    """Per label (row 0 the background): int64 pixel counts and inclusive
    x0, y0, x1, y1, from one native ``stats`` pass over the ink mask."""
    cnt, _, bb = cc_label.stats(labels, ink.astype(np.float32), n)
    bb = bb.astype(np.int64)
    return cnt, bb[:, 0], bb[:, 1], bb[:, 2], bb[:, 3]


def _longest_run(row: np.ndarray, bridge: int = 1) -> int:
    """Longest consecutive True run, tolerating gaps <= ``bridge`` px (raster
    aliasing can nick a 1-px hole in a thin stroke). Bridged gap pixels
    count toward the run length; leading/trailing gaps never bridge."""
    xs = np.nonzero(row)[0]
    if len(xs) == 0:
        return 0
    # consecutive ink pixels are `diff` apart with diff-1 gap pixels
    # between them; a chain breaks where the gap exceeds `bridge`
    brk = np.nonzero(np.diff(xs) > bridge + 1)[0]
    starts = xs[np.concatenate(([0], brk + 1))]
    ends = xs[np.concatenate((brk, [len(xs) - 1]))]
    # each chain also carries the residue of the zero-run just before it
    # (zeros_before % (bridge + 1)): the scalar counter the thresholds above
    # were calibrated against reset its gap count every bridge + 1 zeros
    prev_end = np.concatenate(([-1], ends[:-1]))
    lead = (starts - prev_end - 1) % (bridge + 1)
    return int((ends - starts + 1 + lead).max())


def has_headline(crop: np.ndarray) -> bool:
    """True when the gray uint8 crop of one text box shows a shirorekha: a
    contiguous horizontal ink run in the upper band much wider than the
    glyph height, WITH glyph ink attached directly below it.

    The attachment requirement rejects det boxes over ruled table cells:
    the cell's top rule is a full-width run in the top band, but the cell
    padding leaves the rows under it blank (measured below-run support:
    table rules <= 0.03, Devanagari words >= 0.10)."""
    ink = _ink(crop)
    h, w = ink.shape
    if h < 6 or w < 12:
        return False
    rows_ink = np.nonzero(ink.any(axis=1))[0]
    cols = ink.any(axis=0)
    if len(rows_ink) == 0 or cols.sum() < 8:
        return False
    ink_h = int(rows_ink[-1]) - int(rows_ink[0]) + 1
    xs = np.nonzero(cols)[0]
    x0, x1 = int(xs[0]), int(xs[-1]) + 1
    if x1 - x0 < 10 or ink_h < 6:
        return False
    band_end = int(rows_ink[0]) + max(int(ink_h * HEADLINE_TOP_BAND), 2)
    need = HEADLINE_MIN_RUN_X_HEIGHT * ink_h
    for r in range(int(rows_ink[0]), min(band_end, h)):
        row = ink[r, x0:x1]
        if _longest_run(row) < need:
            continue
        below = ink[r + 1: min(r + 4, h), x0:x1]
        if below.size == 0:
            continue
        support = float((below.any(axis=0) & row).sum()) / max(int(row.sum()), 1)
        if support >= HEADLINE_MIN_BELOW_SUPPORT:
            return True
    return False


def crop_script(crop: np.ndarray) -> str:
    """Classify ONE box crop from a Devanagari-routed page: "devanagari"
    when any word-scale ink component carries a shirorekha, else "latin".

    Hindi forms are script-mixed at the box level: keys are Devanagari but
    values are mostly ASCII (amounts, dates, phones, emails), which the
    devanagari charset cannot read, so each crop goes to the recognizer
    that can. Measured in the reference on 118 resegmented crops from
    rendered Hindi forms: 34/37 Devanagari crops expose a headline
    component, 0/61 ASCII crops do."""
    ink = _ink(crop)
    if not ink.any():
        return "latin"
    labels, n = _label_components(ink)
    if n == 0:
        return "latin"
    cnt, cx0, cy0, cx1, cy1 = _component_boxes(labels, ink, n)
    for ci in range(1, n + 1):
        if (cnt[ci] >= 12
                and cx1[ci] - cx0[ci] + 1 >= 12
                and cy1[ci] - cy0[ci] + 1 >= 6):
            sub = crop[
                max(int(cy0[ci]) - 1, 0): int(cy1[ci]) + 2,
                max(int(cx0[ci]) - 1, 0): int(cx1[ci]) + 2,
            ]
            if has_headline(sub):
                return "devanagari"
    return "latin"


def page_script(page: np.ndarray, quads: np.ndarray, sample: int = 24) -> str:
    """Classify a page's dominant script -> "latin" | "devanagari". quads:
    (N, 4, 2) det boxes in page coords, used only as a region of interest.

    Votes over ink CONNECTED COMPONENTS, not det boxes: det boxes arrive
    padded and often line- or multi-row-scale, which inflates the ink height
    until the headline-run test can never pass. A component IS a word on a
    Devanagari page (the shirorekha connects its glyphs), so the test runs
    at the scale it was calibrated for."""
    if len(quads) == 0:
        return "latin"
    gray = _to_gray(page)
    ph, pw = gray.shape
    roi = np.zeros((ph, pw), bool)
    for q in quads:
        x0 = int(np.clip(q[:, 0].min() - 2, 0, pw))
        x1 = int(np.clip(q[:, 0].max() + 3, x0 + 1, pw))
        y0 = int(np.clip(q[:, 1].min() - 2, 0, ph))
        y1 = int(np.clip(q[:, 1].max() + 3, y0 + 1, ph))
        roi[y0:y1, x0:x1] = True
    vals = gray[roi]
    if vals.size == 0:
        return "latin"
    lo, hi = float(vals.min()), float(np.percentile(vals, 90))
    if hi - lo < 25:
        return "latin"
    ink = (gray < (lo + hi) / 2.0) & roi
    labels, n = _label_components(ink)
    if n == 0:
        return "latin"
    cnt, cx0, cy0, cx1, cy1 = _component_boxes(labels, ink, n)
    # vote only over components WIDE enough to express a shirorekha
    # (w >= 1.8h; the run test needs 1.55x the ink height): a short word
    # cannot pass the test, so counting it as a "no" would read as Latin
    # evidence. Latin print rarely makes wide connected components at all.
    w_all = cx1 - cx0 + 1
    h_all = cy1 - cy0 + 1
    wide = (cnt >= 12) & (h_all >= 6) & (w_all >= np.maximum(12, 1.8 * h_all))
    wide[0] = False
    comps = np.nonzero(wide)[0]
    if not len(comps):
        return "latin"
    # the default sort kind on the int64 counts: ties at the cut resolve as
    # in the reference
    order = comps[np.argsort(-cnt[comps])][: max(sample, 1)]
    hits = 0
    for ci in order:
        crop = gray[
            max(int(cy0[ci]) - 1, 0): int(cy1[ci]) + 2,
            max(int(cx0[ci]) - 1, 0): int(cx1[ci]) + 2,
        ]
        hits += has_headline(crop)
    need = max(PAGE_DEVA_MIN_HITS, PAGE_DEVA_FRACTION * len(order))
    return "devanagari" if hits >= need else "latin"


def _bands(row_mass: np.ndarray) -> list[tuple[int, int]]:
    """Runs of nonzero row mass as [start, end) row ranges."""
    bands = []
    start = None
    for ri, m in enumerate(row_mass):
        if m > 0 and start is None:
            start = ri
        elif m == 0 and start is not None:
            bands.append((start, ri))
            start = None
    if start is not None:
        bands.append((start, len(row_mass)))
    return bands


def _dominant_band(row_mass: np.ndarray) -> tuple[int, int]:
    """The band holding the most ink (the first of equals)."""
    return max(_bands(row_mass), key=lambda t: row_mass[t[0]: t[1]].sum())


def tighten_y(page: np.ndarray, quads: np.ndarray, margin: float = 0.15,
              min_band_mass: float = 0.55) -> np.ndarray:
    """Shrink each AXIS-ALIGNED rec quad's y-extent to its dominant ink row
    band + margin x band height. Tighten-only: never expands, never moves x.

    Det boxes carry det_box_pad_ratio margins, so rec crops render glyphs
    at ~43% of the crop height instead of the ~90% the recognizer trains
    at; dot-leader rows suffer most (measured in the reference: leader CER
    0.95% at tight geometry vs 33% at det-pad geometry). Rotated quads pass
    through, and so does a box whose dominant band holds < min_band_mass of
    its ink (a two-row merged box must not collapse to one row)."""
    if len(quads) == 0:
        return quads
    gray = _to_gray(page)
    ph = gray.shape[0]
    aa = axis_aligned_mask(quads)
    out = quads.copy()
    for i, q in enumerate(quads):
        if not aa[i]:
            continue
        ink = _ink(_crop_aabb(gray, q))
        if not ink.any():
            continue
        row_mass = ink.sum(axis=1).astype(np.float64)
        nz = np.nonzero(row_mass)[0]
        if len(nz) == 0:
            continue
        # contiguous nonzero bands; dominant by mass
        splits = np.nonzero(np.diff(nz) > 1)[0]
        starts = np.concatenate([[0], splits + 1])
        ends = np.concatenate([splits, [len(nz) - 1]])
        bands = [(int(nz[s]), int(nz[e]) + 1) for s, e in zip(starts, ends)]
        masses = [row_mass[b0:b1].sum() for b0, b1 in bands]
        k = int(np.argmax(masses))
        if masses[k] < min_band_mass * row_mass.sum():
            continue
        b0, b1 = bands[k]
        band_h = b1 - b0
        if band_h < 4:
            continue
        y_org = float(np.clip(q[:, 1].min(), 0, ph - 1))
        y_top = max(y_org + b0 - margin * band_h, float(q[:, 1].min()))
        y_bot = min(y_org + b1 + margin * band_h, float(q[:, 1].max()))
        if y_bot - y_top < 4:
            continue
        out[i][[0, 1], 1] = y_top
        out[i][[2, 3], 1] = y_bot
    return out


def split_column_merged(page: np.ndarray, boxes: list[DetectedBox],
                        gap_ratio: float = 1.4) -> list[DetectedBox]:
    """Split det boxes that merged ACROSS form columns (Latin pages): DBNet's
    stride-2 prob map sometimes bridges two fields a column pitch apart
    into one row-level box.

    A box splits ONLY at interior empty-column runs >= gap_ratio x ink
    height, measured over the dominant ink row band (det boxes are padded,
    so neighbour rows bleed into the AABB and would fill the gap). Dot-
    leader rows never split: the dots keep every column occupied, and the
    recognizer is trained on whole leader rows. Boundaries sit at gap
    centres so each piece keeps its margin; y-extents stay untouched."""
    if not boxes:
        return boxes
    gray = _to_gray(page)
    ph, pw = gray.shape
    out: list[DetectedBox] = []
    for b in boxes:
        ink = _ink(_crop_aabb(gray, b.quad))
        if not ink.any():
            out.append(b)
            continue
        row_mass = ink.sum(axis=1)
        b0, b1 = _dominant_band(row_mass)
        xs = np.nonzero(ink[b0:b1].any(axis=0))[0]
        if len(xs) == 0:
            out.append(b)
            continue
        min_gap = max(int(gap_ratio * (b1 - b0)), 10)
        cuts: list[int] = []
        prev_x = int(xs[0])
        for x in xs[1:]:
            if int(x) - prev_x - 1 >= min_gap:
                cuts.append((prev_x + 1 + int(x)) // 2)  # gap centre
            prev_x = int(x)
        if not cuts:
            out.append(b)
            continue
        # crop-local -> page coords via the same clip _crop_aabb applied
        x_org = float(np.clip(b.quad[:, 0].min(), 0, pw - 1))
        y0q = float(b.quad[:, 1].min())
        y1q = float(b.quad[:, 1].max())
        edges = ([float(b.quad[:, 0].min())] + [x_org + c for c in cuts]
                 + [float(b.quad[:, 0].max())])
        for e0, e1 in zip(edges[:-1], edges[1:]):
            if e1 - e0 < 6:
                continue
            quad = np.array([[e0, y0q], [e1, y0q], [e1, y1q], [e0, y1q]], np.float32)
            out.append(DetectedBox(quad=quad, score=b.score))
    return out


def _rows_from_boxes(boxes: list[DetectedBox]) -> list[list[DetectedBox]]:
    """Cluster boxes into text rows by y-centre proximity (0.5x the mean
    height, as engine/reading_order.py does)."""
    items = sorted(boxes, key=lambda b: float(b.quad[:, 1].min()))
    if not items:
        return []
    heights = [float(b.quad[:, 1].max() - b.quad[:, 1].min()) for b in items]
    tol = 0.5 * max(sum(heights) / len(heights), 1.0)
    rows: list[list[DetectedBox]] = []
    for b in items:
        yc = float(b.quad[:, 1].mean())
        for row in rows:
            ry = sum(float(x.quad[:, 1].mean()) for x in row) / len(row)
            if abs(yc - ry) <= tol:
                row.append(b)
                break
        else:
            rows.append([b])
    return rows


def _fit_aspect(segments: list[tuple[int, int]], cols: np.ndarray, ink_h: int,
                word_gap: int, max_aspect: float) -> list[tuple[int, int]]:
    """Recursively split segments wider than max_aspect x ink_h at their
    widest internal empty-column run (>= word_gap). Segments with no such
    gap are left as they are."""
    out: list[tuple[int, int]] = []
    for s0, s1 in segments:
        if (s1 - s0) <= max_aspect * ink_h:
            out.append((s0, s1))
            continue
        # widest empty run strictly inside the segment
        best_gap = best_at = 0
        run = 0
        for x in range(s0, s1):
            if cols[x]:
                if run >= word_gap and run > best_gap:
                    best_gap, best_at = run, x - run
                run = 0
            else:
                run += 1
        if best_gap == 0:
            out.append((s0, s1))
            continue
        out.extend(_fit_aspect([(s0, best_at), (best_at + best_gap, s1)],
                               cols, ink_h, word_gap, max_aspect))
    return out


def resegment_devanagari(page: np.ndarray, boxes: list[DetectedBox],
                         pad_ratio: float = 0.0, pad_ratio_y: float | None = None,
                         latin_pad_ratio: float | None = None) -> list[DetectedBox]:
    """Merge-then-normalize det boxes on a Devanagari page into LINE
    segments:

    1. same-row boxes whose gap is < MERGE_GAP_RATIO x height merge into
       one chain (repairs mid-word splits);
    2. a chain splits only at column-scale gaps (>= LINE_SPLIT_GAP_RATIO x
       ink height), plus forced splits at the widest word gaps while a
       segment is wider than MAX_CROP_ASPECT;
    3. each segment gets tight dominant-band y-extents plus the configured
       margins.

    Hindi pages are script-mixed at the row level too (ASCII amount, date
    and phone rows). With ``latin_pad_ratio`` given, a row with no headline
    component keeps its det boxes untouched, and inside a resegmented row
    each Latin segment (per crop_script) gets ``latin_pad_ratio`` margins,
    the det geometry the Latin recognizer is trained on."""
    if not boxes:
        return boxes
    gray = _to_gray(page)
    ph, pw = gray.shape
    # det can emit one box covering several text rows on dense small-text
    # pages: split those per row first, so every line survives the
    # dominant-band restriction below
    boxes = _split_multirow_boxes(gray, boxes)
    out: list[DetectedBox] = []
    for row in _rows_from_boxes(boxes):
        row.sort(key=lambda b: float(b.quad[:, 0].min()))
        if latin_pad_ratio is not None:
            rx0 = int(np.clip(min(float(b.quad[:, 0].min()) for b in row), 0, pw - 1))
            rx1 = int(np.clip(max(float(b.quad[:, 0].max()) for b in row) + 1, rx0 + 1, pw))
            ry0 = int(np.clip(min(float(b.quad[:, 1].min()) for b in row), 0, ph - 1))
            ry1 = int(np.clip(max(float(b.quad[:, 1].max()) for b in row) + 1, ry0 + 1, ph))
            if crop_script(gray[ry0:ry1, rx0:rx1]) == "latin":
                out.extend(row)
                continue
        chains: list[list[DetectedBox]] = [[row[0]]]
        for b in row[1:]:
            prev = chains[-1][-1]
            h = float(prev.quad[:, 1].max() - prev.quad[:, 1].min())
            gap = float(b.quad[:, 0].min()) - float(prev.quad[:, 0].max())
            if gap < MERGE_GAP_RATIO * max(h, 1.0):
                chains[-1].append(b)
            else:
                chains.append([b])
        for chain in chains:
            x0 = int(np.clip(min(float(b.quad[:, 0].min()) for b in chain), 0, pw - 1))
            x1 = int(np.clip(max(float(b.quad[:, 0].max()) for b in chain) + 1, x0 + 1, pw))
            y0 = int(np.clip(min(float(b.quad[:, 1].min()) for b in chain), 0, ph - 1))
            y1 = int(np.clip(max(float(b.quad[:, 1].max()) for b in chain) + 1, y0 + 1, ph))
            score = float(np.mean([b.score for b in chain]))
            ink = _ink(gray[y0:y1, x0:x1])
            if not ink.any():
                out.extend(chain)  # blank: keep the original boxes
                continue
            # padded det boxes bleed into neighbouring rows: profile only
            # the dominant ink row band, the chain's own line
            b0, b1 = _dominant_band(ink.sum(axis=1))
            ink = ink[b0:b1]
            y0 = y0 + b0
            cols = ink.any(axis=0)
            if not cols.any():
                out.extend(chain)
                continue
            rows_ink = np.nonzero(ink.any(axis=1))[0]
            ink_h = int(rows_ink[-1]) - int(rows_ink[0]) + 1
            # split ONLY at column-scale gaps; keep word gaps merged
            min_gap = max(int(LINE_SPLIT_GAP_RATIO * ink_h), 8)
            segments: list[tuple[int, int]] = []
            xs = np.nonzero(cols)[0]
            seg_start = prev_x = int(xs[0])
            for x in xs[1:]:
                if int(x) - prev_x - 1 >= min_gap:
                    segments.append((seg_start, prev_x + 1))
                    seg_start = int(x)
                prev_x = int(x)
            segments.append((seg_start, prev_x + 1))
            # crops wider than the widest rec bucket pay horizontal squeeze
            word_gap = max(int(WORD_GAP_RATIO * ink_h), 5)
            segments = _fit_aspect(segments, cols, ink_h, word_gap, MAX_CROP_ASPECT)
            for sx0, sx1 in segments:
                seg_rows = np.nonzero(ink[:, sx0:sx1].any(axis=1))[0]
                if len(seg_rows) == 0 or sx1 - sx0 < 3:
                    continue
                sy0 = y0 + int(seg_rows[0])
                sy1 = y0 + int(seg_rows[-1]) + 1
                h_box = float(sy1 - sy0)
                px_ratio = pad_ratio
                py_ratio = pad_ratio if pad_ratio_y is None else pad_ratio_y
                if latin_pad_ratio is not None and crop_script(
                        gray[sy0:sy1, x0 + sx0: x0 + sx1]) == "latin":
                    # an ASCII value inside a Devanagari row: det margins
                    # for the Latin recognizer
                    px_ratio = py_ratio = latin_pad_ratio
                pad_x = max(px_ratio * h_box, 1.0)
                pad_y = max(py_ratio * h_box, 1.0)
                qx0 = float(np.clip(x0 + sx0 - pad_x, 0, pw - 1))
                qx1 = float(np.clip(x0 + sx1 + pad_x, qx0 + 1, pw - 1))
                qy0 = float(np.clip(sy0 - pad_y, 0, ph - 1))
                qy1 = float(np.clip(sy1 + pad_y, qy0 + 1, ph - 1))
                quad = np.array([[qx0, qy0], [qx1, qy0], [qx1, qy1], [qx0, qy1]], np.float32)
                out.append(DetectedBox(quad=quad, score=score))
    return out


def _split_multirow_boxes(gray: np.ndarray, boxes: list[DetectedBox]) -> list[DetectedBox]:
    """Split det boxes covering SEVERAL text rows into one sub-box per row,
    by clustering the box's ink connected components into rows.

    Components cannot fuse across disjoint ink (a projection profile can:
    in a diagonal box's AABB two stair-stepped rows overlap in y); the
    shirorekha joins a word into one component, and each component belongs
    to one text row. Detached diacritics (short or narrow components)
    attach to the nearest row instead of making their own."""
    ph, pw = gray.shape
    out: list[DetectedBox] = []
    for b in boxes:
        ink = _ink(_crop_aabb(gray, b.quad))
        if not ink.any():
            out.append(b)
            continue
        labels, n = _label_components(ink)
        cnt, cx0, cy0, cx1, cy1 = _component_boxes(labels, ink, n)
        comp = [ci for ci in range(1, n + 1) if cnt[ci] >= 3 and cy1[ci] - cy0[ci] + 1 >= 2]
        if not comp:
            out.append(b)
            continue
        heights = np.array([cy1[ci] - cy0[ci] + 1 for ci in comp])
        widths_c = np.array([cx1[ci] - cx0[ci] + 1 for ci in comp])
        masses = np.array([cnt[ci] for ci in comp], np.float64)
        # ink-mass-weighted median height: words carry most of the ink, so
        # this reads as the word height even where marks outnumber words
        order = np.argsort(heights)
        csum = np.cumsum(masses[order])
        med_h = float(heights[order][int(np.searchsorted(csum, csum[-1] / 2.0))])
        # marks are short (anusvara, candrabindu) OR narrow-and-low (a
        # detached vowel sign under a single consonant)
        is_mark = (heights < 0.45 * med_h) | ((heights < 0.7 * med_h) & (widths_c <= 0.9 * med_h))
        main = [ci for ci, m in zip(comp, is_mark) if not m]
        marks = [ci for ci, m in zip(comp, is_mark) if m]
        if not main:
            main, marks = comp, []
        # row clustering by y-centre (running mean, 0.55 x median height);
        # the stable sort keeps label order among equal cy0
        tol = 0.55 * max(med_h, 1.0)
        rows: list[list[int]] = []
        row_yc: list[float] = []
        for ci in sorted(main, key=lambda c: float(cy0[c])):
            yc = float(cy0[ci] + cy1[ci]) / 2.0
            for ri, ry in enumerate(row_yc):
                if abs(yc - ry) <= tol:
                    rows[ri].append(ci)
                    row_yc[ri] = ry + (yc - ry) / len(rows[ri])
                    break
            else:
                rows.append([ci])
                row_yc.append(yc)
        for ci in marks:
            yc = float(cy0[ci] + cy1[ci]) / 2.0
            ri = min(range(len(row_yc)), key=lambda r: abs(yc - row_yc[r]))
            if abs(yc - row_yc[ri]) <= 1.1 * med_h:
                rows[ri].append(ci)
        if len(rows) <= 1:
            out.append(b)
            continue
        x_org = int(np.clip(b.quad[:, 0].min(), 0, pw - 1))
        y_org = int(np.clip(b.quad[:, 1].min(), 0, ph - 1))
        for row in rows:
            rx0 = x_org + int(min(cx0[ci] for ci in row))
            rx1 = x_org + int(max(cx1[ci] for ci in row)) + 1
            ry0 = y_org + int(min(cy0[ci] for ci in row))
            ry1 = y_org + int(max(cy1[ci] for ci in row)) + 1
            if rx1 - rx0 < 3 or ry1 - ry0 < 3:
                continue
            quad = np.array([[rx0, ry0], [rx1, ry0], [rx1, ry1], [rx0, ry1]], np.float32)
            out.append(DetectedBox(quad=quad, score=b.score))
    return out
