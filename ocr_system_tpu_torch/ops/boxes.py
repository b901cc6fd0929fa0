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


def min_area_rect(points: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Rotating-calipers minimum-area rectangle.

    Returns (quad (4,2) ordered tl,tr,br,bl relative to the text direction,
    width, height) where width >= height (text reads along width).

    Pure numpy (hull + rotating calipers), the JAX package's fallback
    branch.
    """
    hull = _convex_hull(points.astype(np.float64))
    if len(hull) == 1:
        p = hull[0]
        q = np.array([p, p, p, p], dtype=np.float32)
        return q, 0.0, 0.0
    if len(hull) == 2:
        p0, p1 = hull
        quad = np.array([p0, p1, p1, p0], dtype=np.float32)
        return quad, float(np.linalg.norm(p1 - p0)), 0.0

    edges = np.diff(np.vstack([hull, hull[:1]]), axis=0)
    angles = np.unique(np.mod(np.arctan2(edges[:, 1], edges[:, 0]), np.pi / 2))
    best = None
    for a in angles:
        rot = np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
        proj = hull @ rot.T
        mn, mx = proj.min(axis=0), proj.max(axis=0)
        area = float(np.prod(mx - mn))
        if best is None or area < best[0]:
            best = (area, a, mn, mx)
    assert best is not None
    _, a, mn, mx = best
    rot = np.array([[np.cos(a), np.sin(a)], [-np.sin(a), np.cos(a)]])
    corners_local = np.array(
        [[mn[0], mn[1]], [mx[0], mn[1]], [mx[0], mx[1]], [mn[0], mx[1]]]
    )
    corners = corners_local @ rot  # inverse rotation = transpose applied right
    w = float(mx[0] - mn[0])
    h = float(mx[1] - mn[1])
    quad = _order_quad(corners.astype(np.float32))
    if h > w:
        w, h = h, w
    return quad, w, h


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
