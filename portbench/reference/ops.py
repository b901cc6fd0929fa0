"""Plain reference steps around the models: the detector's page
enhancement and its text regions, the recognizer's crops and its charsets,
and the comparison of a served text with the reference's logits.

Each follows the served path's published semantics, written anew in plain
NumPy and PyTorch; none imports the program.
"""

from __future__ import annotations

import string

import numpy as np
import torch
import torch.nn.functional as F
from scipy import ndimage

NORM_MEAN = (0.485, 0.456, 0.406)
NORM_STD = (0.229, 0.224, 0.225)
CONTRAST = 1.2
SHARPNESS = 1.1
REC_HEIGHT = 48

# ---- charsets: index 0 is the CTC blank, symbol i + 1 is chars[i] ----

_LATIN = string.digits + string.ascii_letters + string.punctuation + " "
_DEVANAGARI = "".join(chr(c) for c in range(0x0901, 0x0964)) + "।॥" + "".join(
    chr(c) for c in range(0x0966, 0x0970))
CHARSETS = {
    "latin": _LATIN,
    "devanagari": _DEVANAGARI + string.digits + ".,:/-() ",
    "multilingual": _LATIN + _DEVANAGARI,
}


def encode(text: str, chars: str) -> list[int] | None:
    """The label ids of ``text``, or None where a character is not in the
    charset (the recognizer cannot have produced it)."""
    ids = [chars.find(c) + 1 for c in text]
    return None if any(i == 0 for i in ids) else ids


def greedy_text(logp: np.ndarray, chars: str) -> str:
    """Best-path CTC decode of (T, V) log-probabilities."""
    best = logp.argmax(axis=1)
    keep = (best != 0) & np.concatenate([[True], best[1:] != best[:-1]])
    return "".join(chars[i - 1] for i in best[keep])


def ctc_min_max_gap(logp: np.ndarray, labels: list[int]) -> float:
    """The widest gap by which a served token lies below the reference's
    best, along the CTC alignment of ``labels`` that keeps it smallest: over
    the (T, V) reference log-probabilities, min over alignments of the max
    over frames of (best - logp[t, aligned label]). 0 when the reference's
    greedy decode reads ``labels``; inf when no alignment fits in T."""
    t_len = logp.shape[0]
    cost = logp.max(axis=1, keepdims=True) - logp  # (T, V), >= 0
    ext = np.zeros(2 * len(labels) + 1, np.int64)
    ext[1::2] = labels
    n = len(ext)
    # a skip from s - 2 to s is allowed onto a label that differs from the
    # label two states back
    skip = np.zeros(n, bool)
    skip[2:] = (ext[2:] != 0) & (ext[2:] != ext[:-2])
    d = np.full(n, np.inf)
    d[0] = cost[0, ext[0]]
    if n > 1:
        d[1] = cost[0, ext[1]]
    for t in range(1, t_len):
        prev = d.copy()
        prev[1:] = np.minimum(prev[1:], d[:-1])
        prev[2:] = np.where(skip[2:], np.minimum(prev[2:], d[:-2]), prev[2:])
        d = np.maximum(prev, cost[t, ext])
    return float(min(d[-1], d[-2]) if n > 1 else d[-1])


# ---- detector input ----

def gray(page: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB -> (H, W) uint8 luma (BT.601, fixed point with
    15-bit weights, rounded)."""
    if page.ndim == 2:
        return page
    p = page.astype(np.int32)
    return ((p[..., 0] * 9798 + p[..., 1] * 19235 + p[..., 2] * 3735 + (1 << 14)) >> 15
            ).astype(np.uint8)


def wire(g: np.ndarray, bits: int) -> np.ndarray:
    """A uint8 gray image as the detector's wire carries it: 16 levels
    (x 17) at 4 bits, 4 levels rounded to nearest (x 85) at 2, as is at 8."""
    if bits == 4:
        return (g >> 4) * 17
    if bits == 2:
        return ((g.astype(np.uint16) * 3 + 127) // 255 * 85).astype(np.uint8)
    if bits == 8:
        return g
    raise ValueError(f"wire width {bits}")


def enhance(canvas_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W) uint8 canvases -> (B, 3, H, W) float32 model input:
    contrast 1.2 about the page mean, an unsharp mask of 1.1 over a 5-tap
    sigma-1 Gaussian with edge replication, each clamped to [0, 1], then the
    ImageNet normalisation of each channel."""
    u = canvas_u8.float() / 255.0
    m = u.mean(dim=(1, 2), keepdim=True)
    c = (m + (u - m) * CONTRAST).clamp(0.0, 1.0)
    x = torch.arange(-2, 3, dtype=torch.float32, device=u.device)
    k = torch.exp(-0.5 * x**2)
    k = k / k.sum()
    p = F.pad(c[:, None], (2, 2, 2, 2), mode="replicate")
    blur = F.conv2d(F.conv2d(p, k.view(1, 1, 5, 1)), k.view(1, 1, 1, 5))[:, 0]
    s = (blur + (c - blur) * SHARPNESS).clamp(0.0, 1.0)
    mean = torch.tensor(NORM_MEAN, device=u.device).view(1, 3, 1, 1)
    std = torch.tensor(NORM_STD, device=u.device).view(1, 3, 1, 1)
    return (s[:, None] - mean) / std


# ---- recognizer crops ----

def text_regions(prob: np.ndarray, bin_thresh: float, box_thresh: float):
    """DB's text regions of a probability map: 8-connected components of
    the pixels above ``bin_thresh``; a region counts where its mean
    probability reaches ``box_thresh`` and it is not tiny: its extent (the
    distance from its first pixel's centre to its last, as a fitted
    rectangle measures it) under 3 on the short side and under 9 on the
    long one. Returns the label image and, per label 1..n, whether it
    counts."""
    labels, n = ndimage.label(prob > bin_thresh, structure=np.ones((3, 3), bool))
    if n == 0:
        return labels, np.zeros(0, bool)
    mean = np.asarray(ndimage.mean(prob, labels, np.arange(1, n + 1)))
    sides = np.array([(sl[0].stop - sl[0].start - 1, sl[1].stop - sl[1].start - 1)
                      for sl in ndimage.find_objects(labels)])
    tiny = (sides.min(1) < 3) & (sides.max(1) < 9)
    return labels, (mean >= box_thresh) & ~tiny


def quad_mask(shape: tuple[int, int], quads: np.ndarray) -> np.ndarray:
    """The pixels whose centres lie inside any of the convex ``quads``
    ((N, 4, 2) x, y in pixel units), as an (H, W) bool image."""
    mask = np.zeros(shape, bool)
    h, w = shape
    for q in np.asarray(quads, np.float64):
        x0, y0 = np.floor(q.min(0)).astype(int)
        x1, y1 = np.ceil(q.max(0)).astype(int)
        x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1, w), min(y1, h)
        if x1 <= x0 or y1 <= y0:
            continue
        ys, xs = np.mgrid[y0:y1, x0:x1] + 0.5
        sides = []
        for k in range(4):
            (ax, ay), (bx, by) = q[k], q[(k + 1) % 4]
            sides.append((bx - ax) * (ys - ay) - (by - ay) * (xs - ax))
        sides = np.stack(sides)
        mask[y0:y1, x0:x1] |= (sides >= 0).all(0) | (sides <= 0).all(0)
    return mask


def regions_missed(prob: np.ndarray, quads: np.ndarray, bin_thresh: float,
                   box_thresh: float, cover: float = 0.5) -> tuple[int, int]:
    """(text regions of ``prob``, those of them with less than ``cover`` of
    their pixels inside the ``quads``, given in ``prob``'s pixel units)."""
    labels, counts = text_regions(prob, bin_thresh, box_thresh)
    if not counts.any():
        return 0, 0
    n = len(counts)
    flat = labels.ravel()
    area = np.bincount(flat, minlength=n + 1)[1:]
    inside = np.bincount(flat, weights=quad_mask(prob.shape, quads).ravel(),
                         minlength=n + 1)[1:]
    return int(counts.sum()), int((counts & (inside < cover * area)).sum())


def crop_plan(quad: np.ndarray, buckets: tuple[int, ...]) -> tuple[int, int, np.ndarray, bool]:
    """How the served recognizer crops a (4, 2) quad (tl, tr, br, bl):
    its width bucket, its valid width (the text at its own aspect, 48 px
    high, in [16, bucket]), the quad extended along its reading direction
    to fill the bucket, and whether it is axis-aligned (off its box by at
    most 0.15 of its height)."""
    w_px = float(np.linalg.norm(quad[1] - quad[0]))
    h_px = float(np.linalg.norm(quad[3] - quad[0]))
    target = float(np.clip(w_px / max(h_px, 1e-3) * REC_HEIGHT, 16, buckets[-1]))
    bucket = next((b for b in buckets if target <= b), buckets[-1])
    wv = int(np.clip(target, 16, bucket))
    ext = quad.astype(np.float32).copy()
    f = bucket / wv
    ext[1] = quad[0] + (quad[1] - quad[0]) * f
    ext[2] = quad[3] + (quad[2] - quad[3]) * f
    height = max(float(quad[:, 1].max() - quad[:, 1].min()), 1.0)
    dev = max(abs(float(quad[0, 1] - quad[1, 1])), abs(float(quad[0, 0] - quad[3, 0])))
    return bucket, wv, ext, dev <= 0.15 * height


def _bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sample (H, W) float ``img`` at float coordinates, both taps of each
    axis clamped into the image."""
    h, w = img.shape
    y0, x0 = torch.floor(y), torch.floor(x)
    dy, dx = y - y0, x - x0
    y0i, x0i = y0.long().clamp(0, h - 1), x0.long().clamp(0, w - 1)
    y1i, x1i = (y0i + 1).clamp(0, h - 1), (x0i + 1).clamp(0, w - 1)
    top = img[y0i, x0i] * (1 - dx) + img[y0i, x1i] * dx
    bot = img[y1i, x0i] * (1 - dx) + img[y1i, x1i] * dx
    return top * (1 - dy) + bot * dy


def crop(img_u8: torch.Tensor, ext_quads: np.ndarray, axis_aligned: np.ndarray,
         w_valid: np.ndarray, width: int) -> torch.Tensor:
    """(H, W) uint8 page on the device, (N, 4, 2) extended quads -> (N, 3,
    48, width) crops in [0, 1], zero past each valid width. An axis-aligned
    quad samples its bounding box with coordinates clamped into the page
    (border replication); any other quad samples its parallelogram (tl to
    tr, tl to bl) and is zero outside the page."""
    dev = img_u8.device
    img = img_u8.float() / 255.0
    h, w = img.shape
    q = torch.from_numpy(np.asarray(ext_quads, np.float32)).to(dev)
    n = q.shape[0]
    gy = torch.arange(REC_HEIGHT, dtype=torch.float32, device=dev)
    gx = torch.arange(width, dtype=torch.float32, device=dev)
    # axis-aligned: the box's corners, clamped coordinates
    x0, x1 = q[:, :, 0].min(1).values, q[:, :, 0].max(1).values
    y0, y1 = q[:, :, 1].min(1).values, q[:, :, 1].max(1).values
    ys = (y0[:, None] + (y1 - y0)[:, None] * gy / (REC_HEIGHT - 1)).clamp(0, h - 1)
    xs = (x0[:, None] + (x1 - x0)[:, None] * gx / (width - 1)).clamp(0, w - 1)
    aa = _bilinear(img, ys[:, :, None].expand(n, REC_HEIGHT, width),
                   xs[:, None, :].expand(n, REC_HEIGHT, width))
    # general: the parallelogram, zero outside the page
    ex = (q[:, 1] - q[:, 0]) / (width - 1)
    ey = (q[:, 3] - q[:, 0]) / (REC_HEIGHT - 1)
    xi = q[:, 0, 0, None, None] + ex[:, 0, None, None] * gx + ey[:, 0, None, None] * gy[:, None]
    yi = q[:, 0, 1, None, None] + ex[:, 1, None, None] * gx + ey[:, 1, None, None] * gy[:, None]
    inside = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
    gen = torch.where(inside, _bilinear(img, yi, xi), torch.zeros_like(xi))
    sel = torch.from_numpy(np.asarray(axis_aligned, bool)).to(dev)[:, None, None]
    out = torch.where(sel, aa, gen)
    keep = gx[None, None, :] < torch.from_numpy(np.asarray(w_valid)).to(dev)[:, None, None]
    out = torch.where(keep, out, torch.zeros_like(out))
    return out[:, None].expand(n, 3, REC_HEIGHT, width)

