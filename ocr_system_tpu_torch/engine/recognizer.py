"""Recognition stage: on-device crops, width-bucketed batched SVTR, greedy
CTC decode on the device (port of ocr_system_tpu/engine/recognizer.py).

Each quad becomes a fixed (48, W_bucket) crop of the gray uint8 page stack
on the device: axis-aligned quads through the crop kernel
(kernels/crop.py), every other quad through the general quad gather
(ops/sampling.crop_quads). There is no box-height bound on the kernel, so
every axis-aligned quad takes it (the JAX package's non-TPU split). Crops
are grouped by width bucket and count-padded as in the reference; every
group's device work is queued before any result is fetched.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.core.dtypes import DTypePolicy, resolve_device
from ocr_system_tpu_torch.core.weights import load_weights
from ocr_system_tpu_torch.engine.host_image import rgb_to_gray
from ocr_system_tpu_torch.kernels.crop import crop_boxes
from ocr_system_tpu_torch.kernels.enhance import to_unit
from ocr_system_tpu_torch.models.charsets import Charset, get_charset
from ocr_system_tpu_torch.models.recognizer import SVTRRecognizer
from ocr_system_tpu_torch.ops import ctc
from ocr_system_tpu_torch.ops.sampling import (
    axis_aligned_mask,
    crop_quads,
    quads_to_aabbs,
)


@dataclass
class RecResult:
    text: str
    confidence: float


class Recognizer:
    def __init__(self, settings: Settings | None = None, state_dict=None,
                 charset: Charset | None = None, seed: int = 0,
                 device: str | torch.device | None = None):
        self.settings = s = settings or get_settings()
        # "auto" is an ENGINE routing mode; a bare Recognizer under auto is
        # the latin primary
        name = s.rec_charset
        self.charset = charset or get_charset("latin" if name == "auto" else name)
        self.device = resolve_device(device)
        policy = DTypePolicy.from_names(s.compute_dtype, s.param_dtype)
        self.model = SVTRRecognizer(vocab_size=self.charset.size, policy=policy)
        load_weights(self.model, s.rec_checkpoint, state_dict, seed)
        self.model.to(self.device).eval()

    # ---- public API ----

    def recognize_page(self, page: np.ndarray, quads: np.ndarray) -> list[RecResult]:
        """page: (H, W, 3) uint8; quads: (N, 4, 2) float32 in page coords.
        Returns one RecResult per quad (order preserved)."""
        return self.recognize_pages([page], [quads])[0]

    def recognize_pages(self, pages: list[np.ndarray],
                        quads_list: list[np.ndarray]) -> list[list[RecResult]]:
        """Batched multi-page recognition: pages sharing a shape are stacked
        as gray uint8 and ALL their crops decode in width-bucketed batches."""
        results: list[list[RecResult | None]] = [[None] * len(q) for q in quads_list]
        by_shape: dict[tuple[int, int], list[int]] = {}
        for p_i, page in enumerate(pages):
            if len(quads_list[p_i]) > 0:
                by_shape.setdefault(page.shape[:2], []).append(p_i)
        for shape, page_idxs in by_shape.items():
            n_pages = _pad_count(len(page_idxs), max(self.settings.det_batch_size, 1))
            stack = np.zeros((n_pages, *shape), np.uint8)
            for k, p_i in enumerate(page_idxs):
                stack[k] = rgb_to_gray(pages[p_i])
            row_targets = page_idxs + [-1] * (n_pages - len(page_idxs))
            row_quads = [quads_list[p_i] for p_i in page_idxs] + [
                np.zeros((0, 4, 2), np.float32)
            ] * (n_pages - len(page_idxs))
            stack_dev = torch.from_numpy(stack).to(self.device)
            self._rec_on_stack(stack_dev, row_targets, row_quads, results)
        return _fill(results)

    def recognize_on_device_stack(self, stack_dev: torch.Tensor,
                                  quads_list: list[np.ndarray]) -> list[list[RecResult]]:
        """Crops decode straight from a device-resident gray uint8 page stack
        (P, S, S), the det stage's canvases. quads_list: one (N, 4, 2) array
        per stack row, in canvas coords."""
        results: list[list[RecResult | None]] = [[None] * len(q) for q in quads_list]
        page_idxs = [i for i, q in enumerate(quads_list) if len(q) > 0]
        if page_idxs:
            n_rows = stack_dev.shape[0]
            if len(page_idxs) > n_rows // 2:
                row_targets = [i if len(q) > 0 else -1 for i, q in enumerate(quads_list)]
                row_quads = list(quads_list)
            else:
                # sparse wave: compact onto pow2-padded rows, as the
                # reference does to keep its compile keys few
                n_pad = _pad_count(len(page_idxs), n_rows)
                sel = page_idxs + [page_idxs[0]] * (n_pad - len(page_idxs))
                stack_dev = stack_dev.index_select(
                    0, torch.tensor(sel, device=stack_dev.device)
                )
                row_targets = page_idxs + [-1] * (n_pad - len(page_idxs))
                row_quads = [quads_list[i] for i in page_idxs] + [
                    np.zeros((0, 4, 2), np.float32)
                ] * (n_pad - len(page_idxs))
            self._rec_on_stack(stack_dev, row_targets, row_quads, results)
        return _fill(results)

    @torch.inference_mode()
    def _run(self, stack_dev: torch.Tensor, quads: np.ndarray, w_valid: np.ndarray,
             bucket: int, axis_aligned: bool, rows: list[int]):
        """One bucket group: (P, N, 4, 2) quads -> device (ids, conf).
        ``rows``: the stack rows that hold this group's quads (the others
        carry only padding crops, whose results are dropped)."""
        h = self.settings.rec_image_height
        n_pages, n_per_page = w_valid.shape
        widths = torch.from_numpy(w_valid).to(self.device)
        if axis_aligned:
            aabbs = quads_to_aabbs(quads.reshape(-1, 4, 2)).reshape(n_pages, n_per_page, 4)
            # the kernel folds /255, the pad mask and the cast to the
            # compute dtype into the crop
            crops = crop_boxes(stack_dev, torch.from_numpy(aabbs).to(self.device),
                               widths, (h, bucket), self.model.policy.compute_dtype)
        else:
            crops = quad_crops(stack_dev, torch.from_numpy(quads).to(self.device),
                               rows, (h, bucket))
            crops = _mask_pad(crops, widths.reshape(-1))
        crops = crops[:, None].expand(-1, 3, -1, -1)
        logits, lengths = self.model.forward_nchw(crops, widths.reshape(-1))
        ids, conf, _ = ctc.ctc_greedy_decode(logits, lengths)
        return ids, conf

    def _rec_on_stack(self, stack_dev: torch.Tensor, row_targets: list[int],
                      row_quads: list[np.ndarray],
                      results: list[list[RecResult | None]]) -> None:
        """Width-bucket each stack row's quads, split by axis alignment, run
        every group, then fetch. row_targets[k] is the results row that
        stack row k writes to (-1 = padding)."""
        s = self.settings
        h_rec = s.rec_image_height
        buckets = sorted(s.rec_width_buckets)
        n_pages = stack_dev.shape[0]
        per_bucket: dict[tuple[int, bool], list[list[tuple[int, np.ndarray, float]]]] = {}
        for k, quads in enumerate(row_quads):
            if row_targets[k] < 0 or len(quads) == 0:
                continue
            widths_px = np.linalg.norm(quads[:, 1] - quads[:, 0], axis=1)
            heights_px = np.linalg.norm(quads[:, 3] - quads[:, 0], axis=1)
            aspect = widths_px / np.maximum(heights_px, 1e-3)
            target_w = np.clip(aspect * h_rec, 16, buckets[-1])
            aa = axis_aligned_mask(quads)
            for q_i in range(len(quads)):
                b = _first_ge(buckets, target_w[q_i])
                group = per_bucket.setdefault((b, bool(aa[q_i])), [[] for _ in row_quads])
                group[k].append((q_i, quads[q_i], target_w[q_i]))

        # two-phase: queue every group's device work, then fetch
        pending = []
        group_list = list(per_bucket.items())
        for (bucket, axis_aligned), groups in group_list:
            # padding crops cost SVTR compute proportional to the bucket, so
            # the count floor shrinks for wide buckets
            floor = max(1, s.rec_pad_floor * min(s.rec_width_buckets) // bucket)
            n_per_page = max(
                _pad_count(max(len(g) for g in groups), s.rec_batch_size), floor
            )
            q = np.zeros((n_pages, n_per_page, 4, 2), np.float32)
            w_valid = np.full((n_pages, n_per_page), 1, np.int32)
            for k, group in enumerate(groups):
                for j, (q_i, quad, tw) in enumerate(group):
                    # aspect-preserving: extend the quad rightward so the
                    # text renders at natural scale in the first w_valid
                    # columns (the padding region is masked to zero)
                    wv = int(np.clip(tw, 16, bucket))
                    q[k, j] = _extend_quad(quad, bucket / wv)
                    w_valid[k, j] = wv
            rows = [k for k, group in enumerate(groups) if group]
            ids, conf = self._run(stack_dev, q, w_valid, bucket, axis_aligned, rows)
            pending.append((n_per_page, ids, conf))

        for ((bucket, axis_aligned), groups), (n_per_page, ids, conf) in zip(
            group_list, pending
        ):
            texts = ctc.ids_to_text(ids.cpu().numpy(), self.charset)
            confs = conf.cpu().numpy()
            for k, group in enumerate(groups):
                for j, (q_i, _, _) in enumerate(group):
                    flat_i = k * n_per_page + j
                    results[row_targets[k]][q_i] = RecResult(
                        text=texts[flat_i], confidence=float(confs[flat_i])
                    )


def quad_crops(stack_dev: torch.Tensor, quads: torch.Tensor, rows: list[int],
               out_shape: tuple[int, int]) -> torch.Tensor:
    """(P, S, S) u8 stack, (P, N, 4, 2) quads -> (P * N, h, w) float32 crops
    of the listed rows; the other rows' crops stay zero. Each row goes to
    [0, 1] by ``to_unit``, as the JAX package's jitted ``gray / 255.0``
    rounds, on the CPU and the card alike."""
    n_pages, n_per_page = quads.shape[:2]
    crops = torch.zeros((n_pages, n_per_page, *out_shape), device=stack_dev.device)
    for k in rows:
        crops[k] = crop_quads(to_unit(stack_dev[k]), quads[k], out_shape)
    return crops.reshape(-1, *out_shape)


def _fill(results: list[list[RecResult | None]]) -> list[list[RecResult]]:
    return [[r if r is not None else RecResult("", 0.0) for r in row] for row in results]


def _mask_pad(crops: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """Zero the columns beyond each (N, H, W) crop's valid width (training
    pads with black)."""
    cols = torch.arange(crops.shape[-1], device=crops.device)
    keep = cols[None, None, :] < widths[:, None, None]
    return torch.where(keep, crops, torch.zeros_like(crops))


def _extend_quad(quad: np.ndarray, factor: float) -> np.ndarray:
    """Extend a quad along its reading direction by `factor` (tl/bl fixed)."""
    out = quad.copy()
    out[1] = quad[0] + (quad[1] - quad[0]) * factor  # tr
    out[2] = quad[3] + (quad[2] - quad[3]) * factor  # br
    return out


def _first_ge(buckets: list[int], w: float) -> int:
    for b in buckets:
        if w <= b:
            return b
    return buckets[-1]


def _pad_count(n: int, batch: int) -> int:
    """Pad to power-of-two-ish steps up to batch, then multiples of batch —
    bounds compile cache size to O(log batch) entries per bucket."""
    if n >= batch:
        return ((n + batch - 1) // batch) * batch
    p = 1
    while p < n:
        p *= 2
    return min(p, batch)
