"""Detection postprocessing: probability map -> text-region quads.

This is the host/device seam the SURVEY calls out (§7.3 "Host/device split
for postprocessing"): the DBNet head produces a (H, W) shrink-probability map
on device; turning that bitmap into polygons is connected-components +
min-area-rect + unclip — control-flow heavy, tiny data (one byte map per
page), so it runs on host in numpy, with scipy labelling the components.

Port of ocr_system_tpu/ops/boxes.py: the numpy branches only (the JAX
package prefers its native C++ CC op and OpenCV's minAreaRect where
present; the port of those native copies is a later slice).

Algorithm follows "Real-time Scene Text Detection with Differentiable
Binarization" (Liao et al., PAPERS.md): binarize at `bin_thresh`, label
components, take each component's min-area rectangle, score it by the mean
probability inside, dilate ("unclip") by area/perimeter * unclip_ratio to
undo the label shrink, rescale to original page coordinates.

All functions here are pure numpy on host — they are NOT in the jit path.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class DetectedBox:
    quad: np.ndarray  # (4, 2) float32, tl/tr/br/bl in page pixel coords
    score: float

    def flat_polygon(self) -> list[float]:
        """Azure-compatible flat [x0,y0,...,x3,y3] (azure_debug_output.json)."""
        return [float(v) for v in self.quad.reshape(-1)]


def _label_components(binary: np.ndarray) -> tuple[np.ndarray, int]:
    """8-connected components labeling (scipy.ndimage.label)."""
    from scipy import ndimage

    lab, n = ndimage.label(binary, structure=np.ones((3, 3), dtype=np.int32))
    return lab.astype(np.int32), int(n)


def _row_extremes(xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Reduce a filled component's pixels to per-row (min_x, max_x) boundary
    points. The convex hull of a row-filled region equals the hull of its
    row extremes, so this is lossless for min_area_rect — and it shrinks the
    hull input from O(area) to O(height), which is what makes host box
    extraction fast (the Python monotone-chain loop was the detection
    stage's dominant cost at ~0.7 s/page before this reduction)."""
    order = np.argsort(ys, kind="stable")
    ys_s, xs_s = ys[order], xs[order]
    # first/last index of each row in the sorted arrays
    uniq, starts = np.unique(ys_s, return_index=True)
    ends = np.append(starts[1:], len(ys_s))
    mins = np.minimum.reduceat(xs_s, starts)
    maxs = np.maximum.reduceat(xs_s, starts)
    pts = np.empty((2 * len(uniq), 2), np.int64)
    pts[0::2, 0] = mins
    pts[0::2, 1] = uniq
    pts[1::2, 0] = maxs
    pts[1::2, 1] = uniq
    return pts


def _convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain. points: (N, 2) -> hull (M, 2) CCW."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(iterable):
        out: list[np.ndarray] = []
        for p in iterable:
            while len(out) >= 2 and np.cross(out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1], dtype=np.float64)


def _sign(v) -> int:
    return int(v > 0) - int(v < 0)


def _sklansky(xs, ys, stack, off, start, end, nsign, sign2) -> int:
    """One monotone chain of OpenCV's convexHull (its ``Sklansky_``) over
    sorted positions start..end, written into stack[off:]; returns its
    length. Kept statement for statement: the positions it keeps decide
    where the hull starts, and so how ties among equal rectangles fall."""
    incr = 1 if end > start else -1
    pprev, pcur, pnext = start, start + incr, start + 2 * incr
    if start == end or (xs[start] == xs[end] and ys[start] == ys[end]):
        stack[off] = start
        return 1
    stack[off:off + 3] = [pprev, pcur, pnext]
    size = 3
    end += incr
    while pnext != end:
        by = ys[pnext] - ys[pcur]
        if _sign(by) != nsign:
            ax = xs[pcur] - xs[pprev]
            bx = xs[pnext] - xs[pcur]
            ay = ys[pcur] - ys[pprev]
            convexity = float(ay) * float(bx) - float(ax) * float(by)
            if _sign(convexity) == sign2 and (ax != 0 or ay != 0):
                pprev, pcur = pcur, pnext
                pnext += incr
                stack[off + size] = pnext
                size += 1
            elif pprev == start:
                pcur = pnext
                stack[off + 1] = pcur
                pnext += incr
                stack[off + 2] = pnext
            else:
                stack[off + size - 2] = pnext
                pcur = pprev
                pprev = stack[off + size - 4]
                size -= 1
        else:
            pnext += incr
            stack[off + size - 1] = pnext
    return size - 1


def _convex_hull_cv(pts: np.ndarray) -> np.ndarray:
    """``cv2.convexHull(pts, clockwise=False)`` on float32 (N, 2) points:
    the chains of ``_sklansky`` from the x-sorted points, then OpenCV's
    cyclic shift that makes the hull's input indices run monotonically
    where they can. OpenCV sorts with an unstable sort, so where points
    repeat the hull may start elsewhere than cv2's; on 11,000 seeded sets
    with repeats the rectangle never differed."""
    total = len(pts)
    X = [np.float32(v) for v in pts[:, 0]]
    Y = [np.float32(v) for v in pts[:, 1]]
    order = sorted(range(total), key=lambda i: (X[i], Y[i]))
    xs = [X[i] for i in order]
    ys = [Y[i] for i in order]
    miny = maxy = 0
    for i in range(1, total):
        if ys[miny] > ys[i]:
            miny = i
        if ys[maxy] < ys[i]:
            maxy = i
    if xs[0] == xs[-1] and ys[0] == ys[-1]:
        return pts[:1].copy()
    stack = [0] * (total + 3)
    # upper half: counter-clockwise takes the right chain first
    n_left = _sklansky(xs, ys, stack, 0, 0, maxy, -1, 1)
    n_right = _sklansky(xs, ys, stack, n_left, total - 1, maxy, -1, -1)
    hull = [order[stack[n_left + i]] for i in range(n_right - 1)]
    hull += [order[stack[i]] for i in range(n_left - 1, 0, -1)]
    stop = (stack[1] if n_left > 2
            else stack[n_left + n_right - 2] if n_right > 2 else -1)
    # lower half
    n_bl = _sklansky(xs, ys, stack, 0, 0, miny, 1, -1)
    n_br = _sklansky(xs, ys, stack, n_bl, total - 1, miny, 1, 1)
    if stop >= 0:
        check = (stack[1] if n_bl > 2 else stack[2] if n_bl + n_br > 2 else -1)
        if check == stop or (check >= 0 and xs[check] == xs[stop]
                             and ys[check] == ys[stop]):
            # all points on one line: the lower half mirrors the upper
            n_bl, n_br = min(n_bl, 2), min(n_br, 2)
    hull += [order[stack[i]] for i in range(n_bl - 1)]
    hull += [order[stack[n_bl + i]] for i in range(n_br - 1, 0, -1)]
    nout = len(hull)
    if nout >= 3:
        min_i = max_i = lt = 0
        for i in range(1, nout):
            lt += hull[i - 1] < hull[i]
            if 1 < lt <= i - 2:
                break
            if hull[i] < hull[min_i]:
                min_i = i
            if hull[i] > hull[max_i]:
                max_i = i
        dist = abs(max_i - min_i)
        if dist in (1, nout - 1) and (lt <= 1 or lt >= nout - 2):
            ascending = (max_i + 1) % nout == min_i
            i0 = min_i if ascending else max_i
            shifted = hull[i0:] + hull[:i0]
            if i0 > 0 and all((a < b) == ascending
                              for a, b in zip(shifted, shifted[1:])):
                hull = shifted
    return pts[hull]


def _calipers_cv(pts: np.ndarray):
    """OpenCV's ``rotatingCalipers`` (CALIPERS_MINAREARECT) over a hull of
    > 2 float32 points, in its float32 arithmetic and its scan order: the
    calipers start at the bottom, right, top and left points, turn to the
    edge of least angle, and ``area <= minarea`` lets the last of equal
    rectangles win. Returns the corner and the two side vectors."""
    f32 = np.float32
    n = len(pts)
    px = [f32(v) for v in pts[:, 0]]
    py = [f32(v) for v in pts[:, 1]]
    vect, inv_len = [], []
    left = bottom = right = top = 0
    x0, y0 = px[0], py[0]
    left_x = right_x = x0
    top_y = bottom_y = y0
    for i in range(n):
        if x0 < left_x:
            left_x, left = x0, i
        if x0 > right_x:
            right_x, right = x0, i
        if y0 > top_y:
            top_y, top = y0, i
        if y0 < bottom_y:
            bottom_y, bottom = y0, i
        x1, y1 = px[(i + 1) % n], py[(i + 1) % n]
        dx, dy = float(x1) - float(x0), float(y1) - float(y0)
        vect.append((f32(dx), f32(dy)))
        inv_len.append(f32(1.0 / math.sqrt(dx * dx + dy * dy)))
        x0, y0 = x1, y1
    seq = [bottom, right, top, left]
    minarea = f32(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        # the caliper sides as seen from side 0; pick the one whose next
        # hull edge turns least (the rightmost vector)
        v = [vect[k] for k in seq]
        rot = [v[0], (v[1][1], -v[1][0]), (-v[2][0], -v[2][1]), (-v[3][1], v[3][0])]
        main = 0
        for i in range(1, 4):
            if rot[i][1] * rot[main][0] - rot[i][0] * rot[main][1] < 0:
                main = i
        k = seq[main]
        lx, ly = vect[k][0] * inv_len[k], vect[k][1] * inv_len[k]
        base_a, base_b = ((lx, ly), (ly, -lx), (-lx, -ly), (-ly, lx))[main]
        seq[main] = (k + 1) % n
        width = (px[seq[1]] - px[seq[3]]) * base_a + (py[seq[1]] - py[seq[3]]) * base_b
        height = (-(px[seq[2]] - px[seq[0]]) * base_b
                  + (py[seq[2]] - py[seq[0]]) * base_a)
        area = width * height
        if area <= minarea:
            minarea = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    i_left, a1, width, b1, height, i_bottom = best
    a2, b2 = -b1, a1
    c1 = a1 * px[i_left] + py[i_left] * b1
    c2 = a2 * px[i_bottom] + py[i_bottom] * b2
    idet = f32(1) / (a1 * b2 - a2 * b1)
    corner = ((c1 * b2 - c2 * b1) * idet, (a1 * c2 - a2 * c1) * idet)
    return corner, (a1 * width, b1 * width), (a2 * height, b2 * height)


def _min_area_rect_cv(points: np.ndarray):
    """``cv2.minAreaRect`` of OpenCV 5, or None where the hull has fewer
    than three points: ((cx, cy), (w, h), angle) in float32, the angle in
    [-90, 0) degrees (OpenCV 5 turns the calipers' [0, 90] result back
    into that range, swapping the sides at each quarter turn)."""
    f32 = np.float32
    hull = _convex_hull_cv(np.asarray(points, np.float32).reshape(-1, 2))
    if len(hull) < 3:
        return None
    o0, o1, o2 = _calipers_cv(hull)
    cx = o0[0] + (o1[0] + o2[0]) * f32(0.5)
    cy = o0[1] + (o1[1] + o2[1]) * f32(0.5)
    w = f32(math.hypot(float(o1[0]), float(o1[1])))
    h = f32(math.hypot(float(o2[0]), float(o2[1])))
    angle = math.atan2(float(o1[1]), float(o1[0])) * 180.0 / math.pi
    while angle >= 0:
        angle -= 90.0
        w, h = h, w
    return (cx, cy), (w, h), f32(angle)


def _box_points_cv(rect) -> np.ndarray:
    """``cv2.boxPoints``: the four corners in float32."""
    f32 = np.float32
    (cx, cy), (w, h), angle = rect
    rad = float(angle) * math.pi / 180.0
    b = f32(math.cos(rad)) * f32(0.5)
    a = f32(math.sin(rad)) * f32(0.5)
    return np.array([(cx - a * h - b * w, cy + b * h - a * w),
                     (cx + a * h - b * w, cy - b * h - a * w),
                     (cx + a * h + b * w, cy - b * h + a * w),
                     (cx - a * h + b * w, cy + b * h + a * w)], np.float32)


def min_area_rect(points: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Minimum-area rectangle.

    Returns (quad (4,2) ordered tl,tr,br,bl relative to the text direction,
    width, height) where width >= height (text reads along width).

    The JAX package serves cv2.minAreaRect + cv2.boxPoints; the port has
    no cv2, so it carries OpenCV's algorithm in its arithmetic
    (``_min_area_rect_cv``): rectangles of equal area are chosen as cv2
    chooses them, and a 45-degree rectangle, whose corner ``_order_quad``
    duplicates, gets cv2's float32 corners. Where the points span no area
    (a point or a segment) the quad is that point or segment, with height
    0, as the JAX package returns it.
    """
    if len(points) >= 3:
        rect = _min_area_rect_cv(points)
        if rect is not None:
            _, (w, h), _ = rect
            if w > 1e-6 and h > 1e-6:
                quad = _order_quad(_box_points_cv(rect))
                if h > w:
                    w, h = h, w
                return quad, float(w), float(h)
    # a point or a segment: cv2 finds no hull of 3 points, or a rectangle
    # with no width (for pixel coordinates, only where they are collinear)
    hull = _convex_hull(points.astype(np.float64))
    if len(hull) == 1:
        p = hull[0]
        q = np.array([p, p, p, p], dtype=np.float32)
        return q, 0.0, 0.0
    p0 = hull[0]
    p1 = hull[np.argmax(np.linalg.norm(hull - p0, axis=1))]
    quad = np.array([p0, p1, p1, p0], dtype=np.float32)
    return quad, float(np.linalg.norm(p1 - p0)), 0.0


def _order_quad(quad: np.ndarray) -> np.ndarray:
    """Order 4 points tl, tr, br, bl (y-down image coords)."""
    s = quad.sum(axis=1)
    d = quad[:, 0] - quad[:, 1]
    tl = quad[np.argmin(s)]
    br = quad[np.argmax(s)]
    tr = quad[np.argmax(d)]
    bl = quad[np.argmin(d)]
    return np.array([tl, tr, br, bl], dtype=np.float32)


def unclip_quad(quad: np.ndarray, ratio: float = 1.6) -> np.ndarray:
    """Expand a quad outward by DB's unclip rule: offset each edge by
    d = area * ratio / perimeter (a uniform polygon offset; for convex quads
    pushing each vertex along the sum of its two edge normals by d is exact
    enough and avoids a Vatti clipper dependency)."""
    x, y = quad[:, 0], quad[:, 1]
    area = 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    edges = np.roll(quad, -1, axis=0) - quad
    lens = np.linalg.norm(edges, axis=1)
    perimeter = float(lens.sum())
    if perimeter <= 1e-6:
        return quad
    d = area * ratio / perimeter
    # outward normals: orientation-aware (tl,tr,br,bl is clockwise in y-down
    # screen coords, i.e. negative signed area -> flip the left-normal)
    signed_area = 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
    flip = 1.0 if signed_area > 0 else -1.0
    normals = flip * np.stack([edges[:, 1], -edges[:, 0]], axis=1)
    normals /= np.maximum(lens[:, None], 1e-6)
    vert_off = normals + np.roll(normals, 1, axis=0)
    norms = np.linalg.norm(vert_off, axis=1, keepdims=True)
    vert_off = vert_off / np.maximum(norms, 1e-6)
    # scale so the edge moves by exactly d
    cos_half = np.clip(np.abs(np.sum(vert_off * normals, axis=1)), 0.3, 1.0)
    out = quad + vert_off * (d / cos_half)[:, None]
    return _order_quad(out.astype(np.float32))


def _component_analysis(
    binary: np.ndarray,
    prob_map: np.ndarray | None,
    score_map: np.ndarray | None,
    score_stride: int,
) -> tuple[np.ndarray, int, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Label components and gather every per-component statistic the box
    extractor needs: (labels, n, counts int64 (n+1,), score_sums (n+1,),
    bboxes int32 (n+1, 4) x0,y0,x1,y1, moments (n+1, 5)
    sum_x,sum_y,sum_xx,sum_yy,sum_xy).

    The numpy branch of the JAX package's implementation.
    """
    src = score_map if score_map is not None else prob_map
    if src is None:
        raise ValueError("need prob_map or score_map for component scoring")
    stride = score_stride if score_map is not None else 1

    labels, n = _label_components(binary)
    if n == 0:
        z = np.zeros(1, np.float64)
        return (
            labels, 0, np.zeros(1, np.int64), z,
            np.zeros((1, 4), np.int32), np.zeros((1, 5), np.float64),
        )
    flat = labels.reshape(-1)
    if score_map is not None:
        h, w = binary.shape
        yy = (np.arange(h) // stride).clip(0, score_map.shape[0] - 1)
        xx = (np.arange(w) // stride).clip(0, score_map.shape[1] - 1)
        probs = score_map[np.ix_(yy, xx)].reshape(-1)
    else:
        probs = src.reshape(-1)
    counts = np.bincount(flat, minlength=n + 1).astype(np.int64)
    sums = np.bincount(flat, weights=probs, minlength=n + 1)
    ys, xs = np.nonzero(binary)
    comp_of = labels[ys, xs]
    order = np.argsort(comp_of, kind="stable")
    ys_s, xs_s, comp_s = ys[order], xs[order], comp_of[order]
    starts = np.searchsorted(comp_s, np.arange(1, n + 1))
    ends = np.append(starts[1:], len(comp_s))
    bboxes = np.zeros((n + 1, 4), np.int32)
    nz = np.nonzero(ends > starts)[0]
    if len(nz):
        s_nz = starts[nz]
        bboxes[nz + 1, 0] = np.minimum.reduceat(xs_s, s_nz)
        bboxes[nz + 1, 1] = np.minimum.reduceat(ys_s, s_nz)
        bboxes[nz + 1, 2] = np.maximum.reduceat(xs_s, s_nz)
        bboxes[nz + 1, 3] = np.maximum.reduceat(ys_s, s_nz)
    xf = xs.astype(np.float64)
    yf = ys.astype(np.float64)
    moments = np.zeros((n + 1, 5), np.float64)
    moments[:, 0] = np.bincount(comp_of, weights=xf, minlength=n + 1)
    moments[:, 1] = np.bincount(comp_of, weights=yf, minlength=n + 1)
    moments[:, 2] = np.bincount(comp_of, weights=xf * xf, minlength=n + 1)
    moments[:, 3] = np.bincount(comp_of, weights=yf * yf, minlength=n + 1)
    moments[:, 4] = np.bincount(comp_of, weights=xf * yf, minlength=n + 1)
    return labels, n, counts, sums, bboxes, moments


def boxes_from_prob_map(
    prob_map: np.ndarray | None = None,
    bin_thresh: float = 0.3,
    box_thresh: float = 0.6,
    unclip_ratio: float = 1.6,
    min_size: float = 3.0,
    max_boxes: int = 1024,
    scale_xy: tuple[float, float] = (1.0, 1.0),
    clip_wh: tuple[float, float] | None = None,
    binary: np.ndarray | None = None,
    score_map: np.ndarray | None = None,
    score_stride: int = 4,
) -> list[DetectedBox]:
    """prob_map (H, W) float in [0,1] -> ranked quads in page coordinates.

    scale_xy maps model-input coords back to original page pixels (undoes the
    letterbox scale); clip_wh clips quads to the original page size.

    Thin-wire mode (det_prob_wire_bits=1): the device sends the
    ALREADY-BINARIZED mask (`binary`, full map resolution — geometry keeps
    full fidelity) plus a stride-`score_stride` pooled probability map
    (`score_map`) that stands in for per-pixel probs in the component mean
    score; `prob_map` may then be None.
    """
    if binary is None:
        binary = (prob_map > bin_thresh).astype(np.uint8)
    labels, n, counts_i, sums, bboxes, moments = _component_analysis(
        binary, prob_map, score_map, score_stride
    )
    boxes: list[DetectedBox] = []
    if n == 0:
        return boxes
    counts = counts_i.astype(np.float64)
    mean_scores = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
    x0 = bboxes[:, 0].astype(np.float64)
    y0 = bboxes[:, 1].astype(np.float64)
    x1 = bboxes[:, 2].astype(np.float64)
    y1 = bboxes[:, 3].astype(np.float64)

    # ---- vectorized fast path for NEAR-RECTANGULAR components ----
    # A DB shrink component for a straight text word is a filled rectangle;
    # its min-area rect IS its axis-aligned bbox, and the unclip offset has
    # the closed form d = w*h*ratio / (2*(w+h)). Computing hull + rotating
    # calipers per component in Python cost ~0.7 ms/box (~120 ms/page at
    # 157 boxes — the detection stage's dominant wall time, profiled r4);
    # the fill-ratio test routes only genuinely rotated/ragged components
    # (fill < 0.85) through the exact slow path.
    valid = np.zeros(n + 1, bool)
    valid[1:] = (mean_scores[1:] >= box_thresh) & (counts_i[1:] > 0)
    # fill uses pixel-count semantics (+1 spans); the size filter and the
    # emitted quad use EXTENT semantics (x1-x0) to match min_area_rect
    fill = np.where(
        valid,
        counts / np.maximum((x1 - x0 + 1.0) * (y1 - y0 + 1.0), 1.0),
        0.0,
    )
    w_all = x1 - x0
    h_all = y1 - y0
    size_ok = ~(
        (np.minimum(w_all, h_all) < min_size)
        & (np.maximum(w_all, h_all) < min_size * 3)
    )
    # principal-axis angle per component (second moments): a ragged-but-
    # straight word blob (fill well below 0.85 on stroke-heavy pages —
    # measured 0.4-0.8) still reads θ≈0°/90°, where min_area_rect
    # ≈ the AABB anyway; only genuinely tilted components need calipers.
    cnz = np.maximum(counts, 1.0)
    mx = moments[:, 0] / cnz
    my = moments[:, 1] / cnz
    mxx = moments[:, 2] / cnz - mx * mx
    myy = moments[:, 3] / cnz - my * my
    mxy = moments[:, 4] / cnz - mx * my
    theta = 0.5 * np.arctan2(2.0 * mxy, mxx - myy)  # radians, [-pi/2, pi/2]
    dev = np.minimum(np.abs(theta), np.pi / 2 - np.abs(theta))
    axis_aligned = dev < np.deg2rad(3.0)
    fast = valid & size_ok & ((fill >= 0.85) | (axis_aligned & (fill >= 0.3)))
    slow = valid & size_ok & ~fast
    boxes_from_prob_map.last_split = (  # type: ignore[attr-defined]
        int(fast.sum()), int(slow.sum()),
        np.round(fill[slow], 2).tolist(),
    )

    sx, sy = scale_xy
    fast_ids = np.nonzero(fast)[0]
    if len(fast_ids):
        fx0, fx1 = x0[fast_ids], x1[fast_ids]
        fy0, fy1 = y0[fast_ids], y1[fast_ids]
        w = fx1 - fx0
        h = fy1 - fy0
        d = w * h * unclip_ratio / np.maximum(2.0 * (w + h), 1e-6)
        quads = np.empty((len(fast_ids), 4, 2), np.float32)
        quads[:, 0, 0] = quads[:, 3, 0] = (fx0 - d) * sx
        quads[:, 1, 0] = quads[:, 2, 0] = (fx1 + d) * sx
        quads[:, 0, 1] = quads[:, 1, 1] = (fy0 - d) * sy
        quads[:, 2, 1] = quads[:, 3, 1] = (fy1 + d) * sy
        if clip_wh is not None:
            np.clip(quads[..., 0], 0, clip_wh[0] - 1, out=quads[..., 0])
            np.clip(quads[..., 1], 0, clip_wh[1] - 1, out=quads[..., 1])
        for k, comp in enumerate(fast_ids):
            boxes.append(
                DetectedBox(quad=quads[k], score=float(mean_scores[comp]))
            )

    for comp in np.nonzero(slow)[0]:
        bx0, by0, bx1, by1 = (int(v) for v in bboxes[comp])
        sub = labels[by0 : by1 + 1, bx0 : bx1 + 1]
        ys_c, xs_c = np.nonzero(sub == comp)
        pts = _row_extremes(xs_c + bx0, ys_c + by0)
        quad, w, h = min_area_rect(pts)
        if min(w, h) < min_size and max(w, h) < min_size * 3:
            continue
        quad = unclip_quad(quad, unclip_ratio)
        quad[:, 0] *= sx
        quad[:, 1] *= sy
        if clip_wh is not None:
            quad[:, 0] = np.clip(quad[:, 0], 0, clip_wh[0] - 1)
            quad[:, 1] = np.clip(quad[:, 1], 0, clip_wh[1] - 1)
        boxes.append(DetectedBox(quad=quad, score=float(mean_scores[comp])))

    boxes.sort(key=lambda b: -b.score)
    return boxes[:max_boxes]


def boxes_from_stats(
    stats: np.ndarray,
    n_comps: int,
    box_thresh: float = 0.6,
    unclip_ratio: float = 1.6,
    min_size: float = 3.0,
    max_boxes: int = 1024,
    scale_xy: tuple[float, float] = (1.0, 1.0),
    clip_wh: tuple[float, float] | None = None,
) -> list[DetectedBox] | None:
    """Device-computed component stats -> ranked quads, WITHOUT the prob map.

    `stats` is ops/device_boxes.component_stats output for one page:
    (K, 13) [count, score_sum, x0, y0, x1, y1, theta, cx, cy, u0, v0,
    u1, v1] in prob-map coordinates. Applies EXACTLY the gates of
    boxes_from_prob_map's fast path (same formulas — the cross-path
    equivalence test in tests/test_ops keeps them in sync). Rotated
    components get a PRINCIPAL-AXIS box from the device-computed oriented
    extents (near min-area-rect for elongated text; equivalence test
    bounds the IoU). Returns None only on component overflow past K —
    the caller then fetches that page's prob map and falls back to
    boxes_from_prob_map.
    """
    if n_comps > stats.shape[0]:
        return None
    counts = stats[:, 0].astype(np.float64)
    sums = stats[:, 1].astype(np.float64)
    x0, y0, x1, y1 = (stats[:, i].astype(np.float64) for i in (2, 3, 4, 5))
    theta = stats[:, 6].astype(np.float64)
    dev = np.minimum(np.abs(theta), np.pi / 2 - np.abs(theta))
    present = counts > 0
    mean_scores = np.where(present, sums / np.maximum(counts, 1), 0.0)
    valid = present & (mean_scores >= box_thresh)
    fill = np.where(
        valid,
        counts / np.maximum((x1 - x0 + 1.0) * (y1 - y0 + 1.0), 1.0),
        0.0,
    )
    w_all = x1 - x0
    h_all = y1 - y0
    size_ok = ~(
        (np.minimum(w_all, h_all) < min_size)
        & (np.maximum(w_all, h_all) < min_size * 3)
    )
    axis_aligned = dev < np.deg2rad(3.0)
    fast = valid & size_ok & ((fill >= 0.85) | (axis_aligned & (fill >= 0.3)))
    slow = valid & size_ok & ~fast

    boxes: list[DetectedBox] = []
    sx, sy = scale_xy
    for comp in np.nonzero(slow)[0]:
        # principal-axis box: rotate the centroid-relative oriented
        # extents back into page frame (mirrors the host slow path's
        # min_area_rect -> unclip -> size gate sequence)
        cx, cy = stats[comp, 7], stats[comp, 8]
        u0, v0, u1, v1 = (float(stats[comp, i]) for i in (9, 10, 11, 12))
        w = u1 - u0
        h = v1 - v0
        if w < h:  # width reads along the text direction
            w, h = h, w
        if min(w, h) < min_size and max(w, h) < min_size * 3:
            continue
        ct, st = np.cos(theta[comp]), np.sin(theta[comp])
        corners_uv = np.array(
            [[u0, v0], [u1, v0], [u1, v1], [u0, v1]], np.float64
        )
        rot = np.array([[ct, -st], [st, ct]])
        quad = (corners_uv @ rot.T + [cx, cy]).astype(np.float32)
        quad = unclip_quad(_order_quad(quad), unclip_ratio)
        quad[:, 0] *= sx
        quad[:, 1] *= sy
        if clip_wh is not None:
            quad[:, 0] = np.clip(quad[:, 0], 0, clip_wh[0] - 1)
            quad[:, 1] = np.clip(quad[:, 1], 0, clip_wh[1] - 1)
        boxes.append(
            DetectedBox(quad=quad, score=float(mean_scores[comp]))
        )
    fast_ids = np.nonzero(fast)[0]
    if len(fast_ids):
        fx0, fx1 = x0[fast_ids], x1[fast_ids]
        fy0, fy1 = y0[fast_ids], y1[fast_ids]
        w = fx1 - fx0
        h = fy1 - fy0
        d = w * h * unclip_ratio / np.maximum(2.0 * (w + h), 1e-6)
        quads = np.empty((len(fast_ids), 4, 2), np.float32)
        quads[:, 0, 0] = quads[:, 3, 0] = (fx0 - d) * sx
        quads[:, 1, 0] = quads[:, 2, 0] = (fx1 + d) * sx
        quads[:, 0, 1] = quads[:, 1, 1] = (fy0 - d) * sy
        quads[:, 2, 1] = quads[:, 3, 1] = (fy1 + d) * sy
        if clip_wh is not None:
            np.clip(quads[..., 0], 0, clip_wh[0] - 1, out=quads[..., 0])
            np.clip(quads[..., 1], 0, clip_wh[1] - 1, out=quads[..., 1])
        for k_i, comp in enumerate(fast_ids):
            boxes.append(
                DetectedBox(quad=quads[k_i], score=float(mean_scores[comp]))
            )
    boxes.sort(key=lambda b: -b.score)
    return boxes[:max_boxes]


def quad_to_aabb(quad: np.ndarray) -> tuple[float, float, float, float]:
    """(4,2) quad -> (x0, y0, x1, y1) axis-aligned bounds."""
    return (
        float(quad[:, 0].min()),
        float(quad[:, 1].min()),
        float(quad[:, 0].max()),
        float(quad[:, 1].max()),
    )
