"""Detection stage: batched DBNet inference with shape bucketing (port of
ocr_system_tpu/engine/detector.py, ``det_prob_wire_bits=0``).

Pages are letterboxed on the host into square gray uint8 canvases of a few
static sizes (``det_image_buckets``); two 16-level pixels travel per byte
(``det_wire_bits=4``, the only value ported) and are unpacked on the
device. On the device, per bucket batch: skew estimate (FFT), the enhance
kernel (contrast enhancement on, the only mode ported), DBNet, a stride-2
average pool and the component statistics; only the (B, K, 13) stats and
the skew angles come back to the host. Pages whose skew lies in
[MIN_DESKEW_DEG, MAX_DESKEW_DEG] are rotated on the host and the batch runs
again. The gray canvases stay on the device for the recognizer
(``DetResult.canvas_stack``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.core.dtypes import DTypePolicy, resolve_device
from ocr_system_tpu_torch.core.weights import load_weights
from ocr_system_tpu_torch.engine.host_image import (
    resize_linear,
    rgb_to_gray,
    rotate_cubic,
)
from ocr_system_tpu_torch.engine.selection_marks import page_components
from ocr_system_tpu_torch.kernels.enhance import enhance_gray, gray_means, to_unit
from ocr_system_tpu_torch.models.dbnet import DBNet
from ocr_system_tpu_torch.ops import image_ops
from ocr_system_tpu_torch.ops.boxes import (
    DetectedBox,
    boxes_from_prob_map,
    boxes_from_stats,
)
from ocr_system_tpu_torch.ops.device_boxes import component_stats
from ocr_system_tpu_torch.ops.sampling import quads_are_axis_aligned

PROB_STRIDE = 2  # prob map downsample before the component statistics
MIN_DESKEW_DEG = 0.5
MAX_DESKEW_DEG = 45.0


@dataclass
class DetResult:
    boxes: list[DetectedBox]  # quads in FINAL page pixel coords
    skew_angle: float
    page: np.ndarray  # deskewed page (crops/overlay source)
    # device-canvas handoff to the rec stage (skips a second page upload)
    canvas_stack: torch.Tensor | None = None  # (B, S, S) uint8 gray, on device
    canvas_row: int = -1  # this page's row in canvas_stack
    canvas_scale: float = 1.0  # page coords * scale -> canvas coords
    # the page's (H, W) uint8 luma, computed once for every host pass
    # downstream (ink walk, glue split, the mark/handwriting components)
    gray: np.ndarray | None = None
    # selection_marks.page_components(gray), computed in the det stage when
    # selection marks or handwriting detection are on
    cc: tuple | None = None
    # the engine's det stage routes the page: one Recognizer for every box,
    # a list aligned with the boxes, or None (not routed yet)
    routing: object | None = None


class Detector:
    """Owns DBNet and the fused device forward."""

    def __init__(self, settings: Settings | None = None, state_dict=None,
                 seed: int = 0, device: str | torch.device | None = None):
        self.settings = s = settings or get_settings()
        if s.det_prob_wire_bits != 0:
            raise ValueError("the torch port runs det_prob_wire_bits=0 only")
        if s.enable_adaptive_binarization:
            raise ValueError("adaptive binarization is not ported yet")
        if s.det_wire_bits != 4:
            raise ValueError("the torch port runs det_wire_bits=4 only")
        if not s.enable_contrast_enhancement:
            raise ValueError("the torch port runs with contrast enhancement on only")
        self.device = resolve_device(device)
        policy = DTypePolicy.from_names(s.compute_dtype, s.param_dtype)
        self.model = DBNet(policy=policy)
        load_weights(self.model, s.det_checkpoint, state_dict, seed)
        self.model.to(self.device).eval()

    @torch.inference_mode()
    def _forward(self, packed: np.ndarray):
        """Host wire batch -> device (stats, n_comps, 4-bit prob levels,
        skew angles, gray canvases)."""
        s = self.settings
        x = torch.from_numpy(packed).to(self.device)
        b, side = x.shape[0], x.shape[1]
        gray_u8 = torch.stack([x >> 4, x & 15], dim=-1).reshape(b, side, side) * 17
        f = to_unit(gray_u8)
        if s.enable_deskew:
            angles = image_ops.estimate_skew_angle(f)
        else:
            angles = torch.zeros(b, device=self.device)
        # the kernel reads the u8 canvas and writes the compute dtype
        x_in = enhance_gray(gray_u8, gray_means(gray_u8), self.model.policy.compute_dtype)
        prob = self.model.forward_nchw(x_in)
        prob_ds = F.avg_pool2d(prob[:, None], PROB_STRIDE)[:, 0]
        k_top = min(s.det_stats_k, s.max_boxes_per_page)
        stats, n_comps = component_stats(prob_ds, s.det_bin_thresh, k_top)
        # 16-level map kept on the device for the component-overflow
        # fallback, quantized as the reference's 4-bit wire map is
        p4 = (prob_ds * 15.0 + 0.5).to(torch.uint8)
        return stats, n_comps, p4, angles, gray_u8

    def detect_batch(self, pages: list[np.ndarray]) -> list[DetResult]:
        """pages: list of (H, W, 3) uint8 arrays (original sizes)."""
        s = self.settings
        pages = list(pages)
        by_bucket: dict[int, list[int]] = {}
        canvases: dict[int, np.ndarray] = {}
        scales: dict[int, float] = {}
        for i, page in enumerate(pages):
            bucket = _det_bucket(page.shape, s.det_image_buckets)
            canvases[i], scales[i] = _letterbox_host(page, bucket)
            by_bucket.setdefault(bucket, []).append(i)

        results: dict[int, DetResult] = {}
        for bucket, idxs in by_bucket.items():
            batch = np.stack([canvases[i] for i in idxs])
            stats, n_comps, p4, angles, canvas_dev = self._forward(self._pack_wire(batch))
            angles = angles.cpu().numpy()
            # host deskew + a single re-pass for pages that need it
            skewed = [
                j for j in range(len(idxs))
                if MIN_DESKEW_DEG <= abs(float(angles[j])) <= MAX_DESKEW_DEG
            ]
            applied = np.zeros(len(idxs), np.float32)
            if skewed:
                for j in skewed:
                    i = idxs[j]
                    pages[i] = _rotate_host(pages[i], float(angles[j]))
                    canvases[i], scales[i] = _letterbox_host(pages[i], bucket)
                    applied[j] = float(angles[j])
                batch = np.stack([canvases[i] for i in idxs])
                stats, n_comps, p4, _, canvas_dev = self._forward(self._pack_wire(batch))
            stats_np = stats.cpu().numpy()
            n_comps_np = n_comps.cpu().numpy()
            for j, i in enumerate(idxs):
                scale = scales[i]
                h, w = pages[i].shape[:2]
                kw = dict(
                    box_thresh=s.det_box_thresh,
                    unclip_ratio=s.det_unclip_ratio,
                    scale_xy=(PROB_STRIDE / scale, PROB_STRIDE / scale),
                    clip_wh=(w, h),
                    max_boxes=s.max_boxes_per_page,
                )
                boxes = boxes_from_stats(stats_np[j], int(n_comps_np[j]), **kw)
                if boxes is None:
                    # component overflow past K: exact host path over this
                    # page's 16-level map
                    page_prob = p4[j].cpu().numpy().astype(np.float32) / 15.0
                    boxes = boxes_from_prob_map(
                        page_prob, bin_thresh=s.det_bin_thresh, **kw
                    )
                self._ink_and_emit(results, boxes, pages, i, j, scale,
                                   canvas_dev, float(applied[j]))
        return [results[i] for i in range(len(pages))]

    def _ink_and_emit(self, results, boxes, pages, i, j, scale, canvas_dev,
                      applied_angle) -> None:
        """Per-page tail: ink snap/expand, batch quad pad, the page's ink
        components for the mark and handwriting passes, DetResult."""
        s = self.settings
        h, w = pages[i].shape[:2]
        gray_page = rgb_to_gray(pages[i])
        if s.det_ink_snap or s.det_ink_expand:
            # the numpy walk; the JAX package's native ink_walk copy is a
            # later slice of the port
            for b in boxes:
                if quads_are_axis_aligned(b.quad[None]):
                    _ink_snap(gray_page, b.quad, expand_only=not s.det_ink_snap)
        if boxes:
            stack = np.stack([b.quad for b in boxes])
            _pad_quads_batch(
                stack, s.det_box_pad_ratio, w, h, ratio_y=s.det_box_pad_ratio_y,
            )
            for b, q in zip(boxes, stack):
                b.quad[...] = q
        cc = None
        if s.enable_selection_marks or s.enable_handwriting_detection:
            cc = page_components(gray_page)
        results[i] = DetResult(
            boxes=boxes,
            skew_angle=applied_angle,
            page=pages[i],
            canvas_stack=canvas_dev,
            canvas_row=j,
            canvas_scale=scale,
            gray=gray_page,
            cc=cc,
        )

    def _pack_wire(self, batch: np.ndarray) -> np.ndarray:
        """Pack two 16-level pixels per byte along W (det_wire_bits=4);
        unpacked on the device."""
        g4 = batch >> 4
        return (g4[:, :, 0::2] << 4 | g4[:, :, 1::2]).astype(np.uint8)


def _ink_snap(
    gray: np.ndarray, quad: np.ndarray, max_walk_ratio: float = 1.2,
    expand_only: bool = False,
) -> None:
    """Snap an axis-aligned quad's extents to the ink it covers, in place.

    The DB probability map travels at stride 2, so tiny-text boxes lose
    1-2 px per edge to quantization — enough to clip ascenders/descenders
    and the first/last glyph, which costs recognition dearly (measured:
    classical ink-mask boxes at the same recall scored page CER 0.088 vs
    0.28 for raw DB boxes on small-font forms). Walk each edge outward
    while it still meets ink (bounded by max_walk_ratio x box height), then
    pull each edge inward to the tight ink bound.
    """
    h, w = gray.shape
    x0 = int(np.clip(quad[:, 0].min(), 0, w - 1))
    x1 = int(np.clip(quad[:, 0].max(), x0 + 1, w))
    y0 = int(np.clip(quad[:, 1].min(), 0, h - 1))
    y1 = int(np.clip(quad[:, 1].max(), y0 + 1, h))
    box_h = y1 - y0
    walk = max(int(box_h * max_walk_ratio), 2)
    # local background/ink threshold from the window
    wy0, wy1 = max(y0 - walk, 0), min(y1 + walk, h)
    wx0, wx1 = max(x0 - walk, 0), min(x1 + walk, w)
    win = gray[wy0:wy1, wx0:wx1]
    if win.size == 0:
        return
    # histogram 90th percentile on a 2x2-subsampled window: uint8 range
    # makes bincount+cumsum exact enough for a background estimate at ~10x
    # less cost than np.percentile (profiled: percentile was half of
    # _ink_snap, which itself was ~30 ms/page at 157 boxes)
    sub = win[::2, ::2] if win.shape[0] > 8 and win.shape[1] > 8 else win
    hist = np.bincount(sub.reshape(-1), minlength=256)
    csum = np.cumsum(hist)
    bg = float(np.searchsorted(csum, 0.9 * csum[-1]))
    ink_t = max(bg - 50.0, (float(win.min()) + bg) / 2.0)
    dark_cols = (win < ink_t).sum(axis=0)
    dark_rows_full = win < ink_t

    if expand_only:
        # horizontal walk reads only the box's own row band: the full
        # window includes rules/neighbor rows above and below, and a
        # horizontal table rule would otherwise make every column "dark"
        # and drag the edge to the window limit
        dark_cols = dark_rows_full[y0 - wy0 : y1 - wy0].sum(axis=0)

    def col_dark(x):  # page x -> ink pixels in that column of the window
        return dark_cols[x - wx0] > 0

    # horizontal: walk outward over connected ink (recovers clipped first/
    # last glyphs), stopping at the first blank column (inter-word gap)
    nx0 = x0
    while nx0 - 1 >= wx0 and col_dark(nx0 - 1):
        nx0 -= 1
    nx1 = x1
    while nx1 < wx1 - 1 and col_dark(min(nx1, wx1 - 1)):
        nx1 += 1
    # vertical: tight ink rows within the (expanded) x-span
    sub = dark_rows_full[:, nx0 - wx0 : max(nx1 - wx0, nx0 - wx0 + 1)]
    rows = np.nonzero(sub.any(axis=1))[0]
    if len(rows) == 0:
        return
    if expand_only:
        # union with the original extents: tightening measured worse (a
        # snapped edge that guesses wrong clips a glyph — unrecoverable),
        # but EXPANSION is safe and fixes the under-sized DB response on
        # large bold text (a 22px title detected as a 13px band decodes to
        # garbage; round-3 forms diagnosis). Walk the CONTIGUOUS ink band
        # out from the box's own rows, where "ink" means glyph-like rows:
        # a row that is ~all dark is a table rule, and a row whose only
        # dark pixels are a vertical rule (1-2 px) is blank — both stop the
        # walk, so bordered form cells never swallow their rules/neighbors.
        nx0, nx1 = min(nx0, x0), max(nx1, x1)
        span = max(sub.shape[1], 1)
        cnt = sub.sum(axis=1)
        row_ink = (cnt >= max(3, int(0.03 * span))) & (cnt <= 0.9 * span)
        ny0, ny1 = y0, y1
        lim0, lim1 = max(y0 - walk, wy0), min(y1 + walk, wy1)
        while ny0 - 1 >= lim0 and row_ink[ny0 - 1 - wy0]:
            ny0 -= 1
        while ny1 < lim1 and row_ink[min(ny1 - wy0, len(row_ink) - 1)]:
            ny1 += 1
    else:
        ny0, ny1 = wy0 + int(rows[0]), wy0 + int(rows[-1]) + 1
    # reject pathological growth (swallowed a ruled line / neighbor block);
    # expand_only's walks are already bounded per edge by `walk`
    if not expand_only and (
        (ny1 - ny0) > 3.0 * box_h or (nx1 - nx0) > (x1 - x0) + 4 * box_h
    ):
        return
    quad[:, 0] = [nx0, nx1, nx1, nx0]
    quad[:, 1] = [ny0, ny0, ny1, ny1]


def _pad_quads_batch(
    quads: np.ndarray,
    ratio: float,
    page_w: float,
    page_h: float,
    ratio_y: float | None = None,
) -> None:
    """Vectorized _pad_quad over a (N, 4, 2) stack, in place."""
    if len(quads) == 0:
        return
    h_box = quads[:, :, 1].max(axis=1) - quads[:, :, 1].min(axis=1)
    pad_x = np.maximum(ratio * h_box, 1.0)[:, None]
    pad_y = np.maximum(
        (ratio if ratio_y is None else ratio_y) * h_box, 1.0
    )[:, None]
    center = quads.mean(axis=1, keepdims=True)
    direction = np.sign(quads - center)
    quads[:, :, 0] += direction[:, :, 0] * pad_x
    quads[:, :, 1] += direction[:, :, 1] * pad_y
    np.clip(quads[:, :, 0], 0, page_w - 1, out=quads[:, :, 0])
    np.clip(quads[:, :, 1], 0, page_h - 1, out=quads[:, :, 1])


def _det_bucket(shape, buckets: tuple[int, ...]) -> int:
    longest = max(shape[0], shape[1])
    for b in sorted(buckets):
        if longest <= b:
            return b
    return max(buckets)


def _letterbox_host(page: np.ndarray, bucket: int) -> tuple[np.ndarray, float]:
    """Aspect-preserving resize + pad to a GRAY (bucket, bucket) uint8
    canvas: bilinear resize of the RGB page, then luma (the reference's
    cv2.resize + cv2.cvtColor order)."""
    h, w = page.shape[:2]
    scale = min(bucket / h, bucket / w)
    nh, nw = max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)
    resized = rgb_to_gray(resize_linear(page, (nh, nw)))
    canvas = np.full((bucket, bucket), 255, np.uint8)
    canvas[:nh, :nw] = resized
    return canvas, scale


def _rotate_host(page: np.ndarray, angle_deg: float) -> np.ndarray:
    """Deskew rotation about the center, white border fill."""
    return rotate_cubic(page, angle_deg, fill=255)
