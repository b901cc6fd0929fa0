"""The one traffic generator. A mix is a data file under ``traffic/``; this
module reads its parameters and makes the pages, documents and uploads of
one run from ``--seed``.

Page sources:
- ``npz``: committed page images, read by path and held to their sha256;
  each image appears ``copies`` times in the pool, each copy perturbed.
- ``glyph``: synthetic dense pages of word-like strokes (rows every 36 px),
  the row ends a seeded permutation of one fixed set, so that every seed
  carries the same amount of ink.

Perturbations are stratified over the pool and assigned by the seed: every
seed turns, shifts and shades the pool by the same set of amounts, in
another order, so that the seed changes which page gets which and not how
much work a run holds.

Loops:
- ``closed``: documents back to back; each document is the whole pool in a
  seeded order (with ``"extract": true``, each through to its fields).
- ``open``: uploads at the arrival times of a fixed schedule (its own seed
  in the file, so that every run offers the same load): exponential gaps
  at ``schedule_uploads`` stratified quantiles, in a seeded order; each
  upload's page count and source from the schedule, its pages from the
  seed.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F


def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def glyph_page(size: int, row_end: list[int], rows: int, rng: np.random.Generator) -> np.ndarray:
    """A page of word-like ink segments with inter-word gaps on rows every
    36 px (all rows, or ``rows`` of them chosen by the seed)."""
    img = np.full((size, size, 3), 245, np.uint8)
    ys = list(range(40, size - 40, 36))
    if rows:
        ys = sorted(int(y) for y in rng.choice(ys, rows, replace=False))
    for y, end in zip(ys, row_end):
        x = int(rng.integers(20, 60))
        while x < end:  # a word: glyph-like strokes with letter gaps
            for _ in range(int(rng.integers(3, 8))):
                w = int(rng.integers(3, 6))
                h = int(rng.integers(10, 15))
                img[y: y + h, x: min(x + w, end)] = rng.integers(0, 60)
                x += w + int(rng.integers(2, 4))
                if x >= end:
                    break
            x += int(rng.integers(10, 22))  # inter-word gap
    return img


def perturb(pages: list[np.ndarray], angles, shifts, shades) -> list[np.ndarray]:
    """Turn each page about its centre by its angle (degrees) and shift it
    by its (dy, dx) pixels, bilinear with white outside the page, then add
    its gray offset. One batched call on the card where there is one."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    x = torch.from_numpy(np.stack(pages)).to(dev).permute(0, 3, 1, 2).float()
    n, _, h, w = x.shape
    t = torch.deg2rad(torch.tensor(np.asarray(angles), dtype=torch.float64))
    d = torch.tensor([w / 2.0, h / 2.0], dtype=torch.float64)
    rot = torch.stack([torch.stack([t.cos(), -t.sin()], -1),
                       torch.stack([t.sin(), t.cos()], -1)], -2)  # (n, 2, 2) on (x, y)
    lin = rot * d[None, None, :] / d[None, :, None]  # D^-1 R D
    sh = torch.tensor(np.asarray(shifts), dtype=torch.float64)[:, [1, 0]]  # (dx, dy)
    theta = torch.cat([lin, (-sh / d)[:, :, None]], dim=2).float().to(dev)
    grid = F.affine_grid(theta, (n, 3, h, w), align_corners=False)
    ones = torch.ones((n, 1, h, w), device=dev)
    both = F.grid_sample(torch.cat([x, ones], 1), grid, mode="bilinear",
                         padding_mode="zeros", align_corners=False)
    out = both[:, :3] + 255.0 * (1.0 - both[:, 3:])
    out = out + torch.tensor(np.asarray(shades), dtype=torch.float32, device=dev).view(-1, 1, 1, 1)
    out = out.round().clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    return list(out)


def _stratified(n: int, lo: float, hi: float, rng: np.random.Generator) -> np.ndarray:
    return rng.permutation(np.linspace(lo, hi, n))


def make_pool(src: dict, perturbation: dict | None, root: Path,
              rng: np.random.Generator) -> list[np.ndarray]:
    """The pages of one source, each perturbed."""
    if src["kind"] == "npz":
        path = root / src["path"]
        digest = sha256(path)
        if digest != src["sha256"]:
            raise ValueError(f"{src['path']}: sha256 {digest}, the traffic file expects "
                             f"{src['sha256']}")
        with np.load(path) as z:
            images = z["pages"]
        pages = [images[i] for i in range(len(images)) for _ in range(src["copies"])]
    elif src["kind"] == "glyph":
        size, n = src["size"], src["pool"]
        slots = len(range(40, size - 40, 36))
        n_rows = src["rows"] or slots
        ends = np.linspace(size // 4, size - 80, n_rows).astype(int)
        pages = [glyph_page(size, list(rng.permutation(ends)), src["rows"], rng)
                 for _ in range(n)]
    else:
        raise ValueError(f"unknown page source {src['kind']!r}")
    if perturbation:
        n = len(pages)
        r, s, g = (perturbation["rotate_deg"], perturbation["shift_px"],
                   perturbation["gray"])
        angles = _stratified(n, -r, r, rng)
        dy, dx = _stratified(n, -s, s, rng), _stratified(n, -s, s, rng)
        shades = _stratified(n, -g, g, rng)
        pages = perturb(pages, angles, np.stack([dy, dx], 1), shades)
    return pages


@dataclass
class Upload:
    due_s: float  # scheduled arrival, seconds after the window opens
    pages: list[np.ndarray]
    source: int  # index of the page source


@dataclass
class Traffic:
    loop: str
    documents: list[list[np.ndarray]] = field(default_factory=list)
    uploads: list[Upload] = field(default_factory=list)
    extract: bool = False

    def warmup_sets(self) -> list[list[np.ndarray]]:
        """Page lists whose shapes cover what the window runs: one document
        (closed loop), or one upload of each page count from each source
        (open loop)."""
        if self.loop == "closed":
            return [self.documents[0]]
        seen, out = set(), []
        for u in self.uploads:
            key = (len(u.pages), u.source)
            if key not in seen:
                seen.add(key)
                out.append(u.pages)
        return out


def generate(spec: dict, seed: int, seconds: float, root: Path) -> Traffic:
    """The traffic of one run of ``seconds`` from the mix ``spec``."""
    rng = np.random.default_rng(seed)
    if spec["loop"] == "closed":
        pool = make_pool(spec["pages"], spec.get("perturb"), root, rng)
        docs = [[pool[i] for i in rng.permutation(len(pool))[: spec["doc_pages"]]]
                for _ in range(spec["documents"])]
        return Traffic("closed", documents=docs, extract=spec.get("extract", False))
    if spec["loop"] != "open":
        raise ValueError(f"unknown loop {spec['loop']!r}")
    pools = [make_pool(s["pages"], spec.get("perturb"), root, rng) for s in spec["sources"]]
    sched = np.random.default_rng(spec["schedule_seed"])
    n = spec["schedule_uploads"]
    # exponential gaps at the quantiles (i + 1/2) / n, in the schedule's
    # order: Poisson arrivals whose count over the schedule is the
    # expected one
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / spec["rate_per_s"]
    due = np.cumsum(sched.permutation(gaps))
    sizes = [k for k, _ in spec["upload_pages"]]
    size_p = [p for _, p in spec["upload_pages"]]
    shares = [s["share"] for s in spec["sources"]]
    uploads = []
    for t in due[due < seconds]:
        k = int(sched.choice(sizes, p=size_p))
        src = int(sched.choice(len(shares), p=shares))
        pages = [pools[src][int(i)] for i in rng.integers(len(pools[src]), size=k)]
        uploads.append(Upload(float(t), pages, src))
    return Traffic("open", uploads=uploads, extract=spec.get("extract", False))
