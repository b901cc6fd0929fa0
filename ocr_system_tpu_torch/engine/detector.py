"""Detection stage: batched DBNet inference with shape bucketing (port of
ocr_system_tpu/engine/detector.py).

Pages are letterboxed on the host into square gray uint8 canvases of a few
static sizes (``det_image_buckets``) and travel packed to ``det_wire_bits``
per pixel (8; 4: two 16-level pixels per byte, the default; 2: four 4-level
pixels per byte), unpacked on the device. On the device, per bucket batch:
skew estimate (FFT), enhancement, DBNet and a stride-2 average pool. With
contrast enhancement on and adaptive binarization off (the default) the
enhance kernel serves; otherwise the JAX detector composes contrast,
sharpness, binarization and normalisation in plain ops, and so does the
port. What comes back to the host follows ``det_prob_wire_bits``: 0 (the
default) the (B, K, 13) component statistics, with a 16-level map kept on
the device for the component-overflow fallback; 1 a bitpacked binarized
map and a stride-4 pooled 16-level score map; 4 the 16-level map, two
pixels per byte; 8 the map in uint8. Pages whose skew lies in
[MIN_DESKEW_DEG, MAX_DESKEW_DEG] are turned on the engine's device
(``turn_pages``: on a card the rotate kernel, one launch per page shape;
on the CPU ``host_image.rotate_cubic``), re-letterboxed on the host, and
the batch runs again in the same mode. The gray canvases stay on the
device for the recognizer (``DetResult.canvas_stack``).

Under a mesh with dp > 1 (``core.mesh.engine_mesh``: the one set by
``mesh_context``, else the card's default; a CPU engine with no mesh set
runs unsharded) each bucket batch is padded to a multiple of dp with white
canvases and split over the dp devices, and each device runs the wire
unpack, the skew estimate, the enhance kernel, DBNet and the component
statistics on its own pages; the canvases stay split
(``core.mesh.ShardedBatch``) for the recognizer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.core.dtypes import DTypePolicy, resolve_device
from ocr_system_tpu_torch.core.mesh import (
    DATA_AXIS,
    Mesh,
    ShardedBatch,
    all_gather,
    engine_mesh,
    pad_to_multiple,
    shard_batch,
    shard_scope,
)
from ocr_system_tpu_torch.core.weights import load_weights
from ocr_system_tpu_torch.engine.host_image import (
    resize_linear,
    rgb_to_gray,
    rotate_cubic,
)
from ocr_system_tpu_torch.engine.selection_marks import page_components
from ocr_system_tpu_torch.kernels.enhance import CONTRAST, SHARPNESS, enhance_gray, gray_means, to_unit
from ocr_system_tpu_torch.kernels.rotate import rotate_pages
from ocr_system_tpu_torch.models.dbnet import DBNet
from ocr_system_tpu_torch.native.ink_walk import ink_expand_batch
from ocr_system_tpu_torch.ops import image_ops
from ocr_system_tpu_torch.ops.boxes import (
    DetectedBox,
    boxes_from_prob_map,
    boxes_from_stats,
)
from ocr_system_tpu_torch.ops.device_boxes import component_stats
from ocr_system_tpu_torch.ops.sampling import quads_are_axis_aligned
from ocr_system_tpu_torch.parallel.sharding import replicas
from ocr_system_tpu_torch.utils.profiler import span

PROB_STRIDE = 2  # prob map downsample before the host transfer
SCORE_STRIDE = 4  # the pooled score map's stride (det_prob_wire_bits=1)
MIN_DESKEW_DEG = 0.5
MAX_DESKEW_DEG = 45.0
WIRE_BITS = (2, 4, 8)
PROB_WIRE_BITS = (0, 1, 4, 8)


@dataclass
class DetResult:
    boxes: list[DetectedBox]  # quads in FINAL page pixel coords
    skew_angle: float
    page: np.ndarray  # deskewed page (crops/overlay source)
    # the stride-2 map the boxes came from, in model coordinates: float in
    # [0, 1] under det_prob_wire_bits 4 and 8, the binarized map under 1,
    # None under 0 (only statistics come back)
    prob_map: np.ndarray | None = None
    # device-canvas handoff to the rec stage (skips a second page upload)
    # (B, S, S) uint8 gray, on the device (split over dp under a mesh)
    canvas_stack: torch.Tensor | ShardedBatch | None = None
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
        if s.det_wire_bits not in WIRE_BITS:
            raise ValueError(f"det_wire_bits={s.det_wire_bits}: the port runs {WIRE_BITS}")
        if s.det_prob_wire_bits not in PROB_WIRE_BITS:
            raise ValueError(
                f"det_prob_wire_bits={s.det_prob_wire_bits}: the port runs {PROB_WIRE_BITS}")
        # the enhance kernel runs exactly where the JAX detector runs its
        # Pallas kernel (ocr_system_tpu/engine/detector.py, use_pallas)
        self.use_kernel = s.enable_contrast_enhancement and not s.enable_adaptive_binarization
        self.device = resolve_device(device)
        policy = DTypePolicy.from_names(s.compute_dtype, s.param_dtype)
        self.model = DBNet(policy=policy)
        load_weights(self.model, s.det_checkpoint, state_dict, seed)
        self.model.to(self.device).eval()

    def _preprocess(self, f: torch.Tensor) -> torch.Tensor:
        """(H, W) float32 page in [0, 1] -> (3, H, W) float32 model input,
        the JAX detector's plain composition."""
        s = self.settings
        img = f
        if s.enable_contrast_enhancement:
            img = image_ops.enhance_contrast(img, CONTRAST)
            img = image_ops.enhance_sharpness(img, SHARPNESS)
        if s.enable_adaptive_binarization:
            img = image_ops.adaptive_binarize(img)
        return image_ops.normalize_for_model(img).permute(2, 0, 1)

    def _forward(self, packed: np.ndarray) -> dict:
        """Host wire batch (B pages) -> the device outputs of
        det_prob_wire_bits (``_forward_device``) for the B pages; under a dp
        mesh each dp device runs its share, and "canvas" is the split
        stack (pad pages included, as the JAX detector's)."""
        packed, n_real = self._pad_for_dp(packed)
        packed = torch.from_numpy(packed)
        mesh = self._mesh()
        if mesh is None:
            out = self._forward_device(packed.to(self.device), self.model)
        else:
            models = replicas(self.model, mesh)
            outs = []
            for i, shard in enumerate(shard_batch(mesh, packed)):
                with shard_scope(**{DATA_AXIS: i}):
                    outs.append(self._forward_device(shard, models[i]))
            out = {k: all_gather([o[k] for o in outs], device=self.device)
                   for k in outs[0] if k != "canvas"}
            out["canvas"] = ShardedBatch([o["canvas"] for o in outs], mesh)
        return {k: v if k == "canvas" else v[:n_real] for k, v in out.items()}

    @torch.inference_mode()
    def _forward_device(self, packed: torch.Tensor, model: DBNet) -> dict[str, torch.Tensor]:
        """Wire batch on a device -> the device outputs of
        det_prob_wire_bits (module doc): "angles" and "canvas" (the gray u8
        canvases) always; "stats", "n_comps" and the packed 16-level "prob"
        under 0; the bitpacked "prob" and packed "score" under 1; the packed
        "prob" under 4; the u8 "prob" under 8."""
        s = self.settings
        gray_u8 = unpack_wire(packed, s.det_wire_bits)
        f = to_unit(gray_u8)
        if s.enable_deskew:
            angles = image_ops.estimate_skew_angle(f)
        else:
            angles = torch.zeros(f.shape[0], device=f.device)
        if self.use_kernel:
            # the kernel reads the u8 canvas and writes the compute dtype
            x_in = enhance_gray(gray_u8, gray_means(gray_u8), model.policy.compute_dtype)
        else:
            # contrast off or binarization on: the JAX detector composes the
            # steps in plain ops and runs no Pallas kernel, so the port runs
            # no kernel here either
            x_in = torch.stack([self._preprocess(img) for img in f])
        prob = model.forward_nchw(x_in)
        prob_ds = F.avg_pool2d(prob[:, None], PROB_STRIDE)[:, 0]
        out = {"angles": angles, "canvas": gray_u8}
        mode = s.det_prob_wire_bits
        if mode == 0:
            k_top = min(s.det_stats_k, s.max_boxes_per_page)
            out["stats"], out["n_comps"] = component_stats(prob_ds, s.det_bin_thresh, k_top)
            out["prob"] = pack_levels4(prob_ds)
        elif mode == 1:
            bits = (prob_ds > s.det_bin_thresh).to(torch.uint8)
            b, h, w = bits.shape
            weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8,
                                   device=bits.device)
            out["prob"] = (bits.view(b, h, w // 8, 8) * weights).sum(-1).to(torch.uint8)
            out["score"] = pack_levels4(F.avg_pool2d(prob_ds[:, None], SCORE_STRIDE)[:, 0])
        elif mode == 4:
            out["prob"] = pack_levels4(prob_ds)
        else:
            out["prob"] = (prob_ds * 255.0 + 0.5).to(torch.uint8)
        return out

    def detect_batch(self, pages: list[np.ndarray]) -> list[DetResult]:
        """pages: list of (H, W, 3) uint8 arrays (original sizes).

        Spans (``utils/profiler``): ``det.letterbox`` (the host letterbox,
        stack and wire pack), ``det.forward`` (the device forward's dispatch
        and the host reads of its outputs), ``det.turn`` (the deskew turn of
        skewed pages, ``turn_pages``: on a card the copies and the kernel,
        counting ``turn.card_pages``), ``det.emit`` (boxes, ink walk, page
        components), and ``device_sync`` around each read that waits for
        the card."""
        s = self.settings
        pages = list(pages)
        by_bucket: dict[int, list[int]] = {}
        canvases: dict[int, np.ndarray] = {}
        scales: dict[int, float] = {}
        with span("det.letterbox"):
            for i, page in enumerate(pages):
                bucket = _det_bucket(page.shape, s.det_image_buckets)
                canvases[i], scales[i] = _letterbox_host(page, bucket)
                by_bucket.setdefault(bucket, []).append(i)

        results: dict[int, DetResult] = {}
        for bucket, idxs in by_bucket.items():
            with span("det.letterbox"):
                wire = self._pack_wire(np.stack([canvases[i] for i in idxs]))
            with span("det.forward"):
                out = self._forward(wire)
                with span("device_sync"):
                    angles = out["angles"].cpu().numpy()
            # host deskew + a single re-pass for pages that need it
            skewed = [
                j for j in range(len(idxs))
                if MIN_DESKEW_DEG <= abs(float(angles[j])) <= MAX_DESKEW_DEG
            ]
            applied = np.zeros(len(idxs), np.float32)
            if skewed:
                with span("det.turn"):
                    turned = turn_pages([pages[idxs[j]] for j in skewed],
                                        [float(angles[j]) for j in skewed], self.device)
                    for j, page in zip(skewed, turned):
                        i = idxs[j]
                        pages[i] = page
                        with span("det.letterbox"):
                            canvases[i], scales[i] = _letterbox_host(pages[i], bucket)
                        applied[j] = float(angles[j])
                with span("det.letterbox"):
                    wire = self._pack_wire(np.stack([canvases[i] for i in idxs]))
                with span("det.forward"):
                    out = self._forward(wire)
            with span("det.forward"):
                host = self._fetch(out)
            with span("det.emit"):
                for j, i in enumerate(idxs):
                    boxes, prob_map = self._boxes(out, host, j, scales[i], pages[i].shape[:2])
                    self._ink_and_emit(results, boxes, pages, i, j, scales[i], prob_map,
                                       out["canvas"], float(applied[j]))
        return [results[i] for i in range(len(pages))]

    def _fetch(self, out: dict) -> dict:
        """The host copies of the forward's outputs that the boxes read:
        under det_prob_wire_bits 0 the statistics and component counts;
        otherwise the map as float32 in [0, 1] (1: the binary map, and the
        stride-4 score map)."""
        mode = self.settings.det_prob_wire_bits
        with span("device_sync"):
            if mode == 0:
                return {"stats": out["stats"].cpu().numpy(),
                        "n_comps": out["n_comps"].cpu().numpy()}
            prob = out["prob"].cpu().numpy()
            score = out["score"].cpu().numpy() if mode == 1 else None
        if mode == 1:
            # bits -> the binary geometry mask; the score map -> stride-4
            # floats for the component mean-score gate
            return {"prob": np.unpackbits(prob, axis=2), "score": unpack_levels4(score)}
        if mode == 4:
            return {"prob": unpack_levels4(prob)}
        return {"prob": prob.astype(np.float32) / 255.0}

    def _boxes(self, out: dict, host: dict, j: int, scale: float, page_hw: tuple[int, int]
               ) -> tuple[list[DetectedBox], np.ndarray | None]:
        """Row ``j``'s boxes in page coordinates, and the map they came from
        (None under det_prob_wire_bits 0)."""
        s = self.settings
        h, w = page_hw
        kw = dict(
            box_thresh=s.det_box_thresh,
            unclip_ratio=s.det_unclip_ratio,
            scale_xy=(PROB_STRIDE / scale, PROB_STRIDE / scale),
            clip_wh=(w, h),
            max_boxes=s.max_boxes_per_page,
        )
        mode = s.det_prob_wire_bits
        if mode == 0:
            boxes = boxes_from_stats(host["stats"][j], int(host["n_comps"][j]), **kw)
            if boxes is None:
                # component overflow past K: exact host path over this
                # page's 16-level map
                with span("device_sync"):
                    packed = out["prob"][j:j + 1].cpu().numpy()
                boxes = boxes_from_prob_map(unpack_levels4(packed)[0],
                                            bin_thresh=s.det_bin_thresh, **kw)
            return boxes, None
        prob_map = host["prob"][j]
        if mode == 1:
            return boxes_from_prob_map(
                binary=prob_map.astype(np.uint8), score_map=host["score"][j],
                score_stride=SCORE_STRIDE, bin_thresh=s.det_bin_thresh, **kw,
            ), prob_map
        return boxes_from_prob_map(prob_map, bin_thresh=s.det_bin_thresh, **kw), prob_map

    def _ink_and_emit(self, results, boxes, pages, i, j, scale, prob_map, canvas_dev,
                      applied_angle) -> None:
        """Per-page tail: ink snap/expand, batch quad pad, the page's ink
        components for the mark and handwriting passes, DetResult."""
        s = self.settings
        h, w = pages[i].shape[:2]
        gray_page = rgb_to_gray(pages[i])
        if s.det_ink_snap or s.det_ink_expand:
            aa = [b for b in boxes if quads_are_axis_aligned(b.quad[None])]
            if s.det_ink_snap:
                for b in aa:
                    _ink_snap(gray_page, b.quad)
            elif aa:
                # expand-only serving path: one native call per page,
                # without the GIL (the det/rec thread overlap goes on)
                stack = np.stack([b.quad for b in aa])
                ink_expand_batch(gray_page, stack)
                for b, q in zip(aa, stack):
                    b.quad[...] = q
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
            prob_map=prob_map,
            canvas_stack=canvas_dev,
            canvas_row=j,
            canvas_scale=scale,
            gray=gray_page,
            cc=cc,
        )

    # ---- dp sharding ----

    def _mesh(self) -> Mesh | None:
        """The serving mesh when it has dp > 1, else None; resolved at first
        use, as the JAX detector's."""
        if not hasattr(self, "_mesh_cache"):
            mesh = engine_mesh(self.device)
            self._mesh_cache = mesh if mesh is not None and mesh.shape.get(DATA_AXIS, 1) > 1 \
                else None
        return self._mesh_cache

    def _pad_for_dp(self, batch: np.ndarray) -> tuple[np.ndarray, int]:
        """Pad the wire batch to a multiple of the dp axis so it splits
        evenly; padded pages are white canvases (255 bytes are white at
        every wire width), sliced off after."""
        mesh = self._mesh()
        n = batch.shape[0]
        if mesh is None:
            return batch, n
        pad = pad_to_multiple(n, mesh.shape[DATA_AXIS]) - n
        if pad:
            batch = np.concatenate([batch, np.full((pad, *batch.shape[1:]), 255, batch.dtype)])
        return batch, n

    def _pack_wire(self, batch: np.ndarray) -> np.ndarray:
        """Pack the (B, S, S) u8 canvases along W to det_wire_bits: two
        16-level pixels per byte (4), four 4-level pixels per byte (2), or
        as they are (8); unpacked on the device (``unpack_wire``)."""
        bits = self.settings.det_wire_bits
        if bits == 4:
            g4 = batch >> 4
            return (g4[:, :, 0::2] << 4 | g4[:, :, 1::2]).astype(np.uint8)
        if bits == 2:
            # round to the nearest of 4 levels (floor costs ~0.5 level of
            # error on antialiased glyph edges — measurable at 12px fonts)
            g2 = (batch.astype(np.uint16) * 3 + 127) // 255
            return (
                g2[:, :, 0::4] << 6 | g2[:, :, 1::4] << 4
                | g2[:, :, 2::4] << 2 | g2[:, :, 3::4]
            ).astype(np.uint8)
        return batch


def unpack_wire(x: torch.Tensor, bits: int) -> torch.Tensor:
    """(B, S, S * bits / 8) packed u8 -> (B, S, S) u8 gray, each level
    scaled back to 0..255 (x 17 for 16 levels, x 85 for 4)."""
    b, side = x.shape[0], x.shape[1]
    if bits == 4:
        return torch.stack([x >> 4, x & 15], dim=-1).reshape(b, side, side) * 17
    if bits == 2:
        parts = [(x >> sh) & 3 for sh in (6, 4, 2, 0)]
        return torch.stack(parts, dim=-1).reshape(b, side, side) * 85
    return x


def pack_levels4(p: torch.Tensor) -> torch.Tensor:
    """(B, H, W) float in [0, 1] -> (B, H, W / 2) u8: 16 levels rounded to
    nearest, two pixels per byte, the left one in the high nibble."""
    q = (p * 15.0 + 0.5).to(torch.uint8)
    return q[:, :, 0::2] << 4 | q[:, :, 1::2]


def unpack_levels4(p: np.ndarray) -> np.ndarray:
    """Host side of ``pack_levels4``: (B, H, W / 2) u8 -> (B, H, W)
    float32 in [0, 1]."""
    hi = (p >> 4).astype(np.float32)
    lo = (p & 15).astype(np.float32)
    return np.stack([hi, lo], axis=-1).reshape(p.shape[0], p.shape[1], -1) / 15.0


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


def turn_pages(pages: list[np.ndarray], angles: list[float],
               device: str | torch.device | None = None) -> list[np.ndarray]:
    """Deskew rotation of each page about its center by its angle, white
    border fill, each page as a new (H, W[, C]) uint8 array:
    ``host_image.rotate_cubic`` bit for bit. On a CUDA ``device`` the pages
    of one shape go up as one stack, the rotate kernel turns them in one
    launch and they come back as one copy (the pages returned are rows of
    it, in pageable memory of their own); elsewhere (``None`` included)
    ``rotate_cubic`` turns them on the host."""
    if device is None or torch.device(device).type != "cuda":
        return [rotate_cubic(p, a, fill=255) for p, a in zip(pages, angles, strict=True)]
    out: list[np.ndarray | None] = [None] * len(pages)
    for ks, stack in _stacks_by_shape(pages):
        turned = rotate_pages(torch.from_numpy(stack).to(device), [angles[k] for k in ks])
        host = turned.cpu().numpy().reshape(len(ks), *pages[ks[0]].shape)
        for k, page in zip(ks, host):
            out[k] = page
    return out


def _stacks_by_shape(pages: list[np.ndarray]) -> list[tuple[list[int], np.ndarray]]:
    """The pages grouped by shape, in order of first appearance: each
    group's indices and its (n, H, W, C) uint8 stack in C order, whatever
    the pages' strides (``np.stack`` keeps the inputs' stride order, and a
    page may be a view of planar storage)."""
    by_shape: dict[tuple[int, ...], list[int]] = {}
    for k, p in enumerate(pages):
        by_shape.setdefault(p.shape, []).append(k)
    groups = []
    for shape, ks in by_shape.items():
        stack = np.empty((len(ks), *shape), np.uint8)
        for row, k in enumerate(ks):
            stack[row] = pages[k]
        groups.append((ks, stack.reshape(len(ks), *shape[:2], -1)))
    return groups


def _rotate_host(page: np.ndarray, angle_deg: float,
                 device: str | torch.device | None = None) -> np.ndarray:
    """Deskew rotation about the center, white border fill, on ``device``
    (``turn_pages``; the JAX detector's function of this name turns on the
    host)."""
    return turn_pages([page], [angle_deg], device)[0]
