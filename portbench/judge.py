"""Whether what the timed path produced is right: the served outputs held
against the plain float32 references of ``reference/``, after the window.

Six comparisons of its own, and any number of comparison files; a cell
compares those that its ``limits/<cell>.json`` names, each against a limit
of its own set from the readings of ``tools/calibrate.py`` (PERF.md gives
them):

- ``canvas_px``: the detector's canvases (the pages as its wire carries
  them, which the recognizer crops too) against the reference's own luma
  and wire quantization of each page the program returned: mismatched
  pixels, exact.
- ``det_mad``: the detector's probability map (enhance kernel and DBNet)
  against the reference's map of the same canvas, both pooled to stride 2
  as the box stage reads them: per page, the mean absolute difference; the
  widest page.
- ``det_missed``: over the pages of the same waves, the share of the
  reference map's text regions (DB's rule: 8-connected components above
  the binarization threshold whose mean reaches the box threshold, the
  tiny ones left out) that the words served on those pages do not cover
  (less than half of a region's pixels inside a served word polygon, or a
  handwriting box, which stands for the words under it). A page served
  empty, or words the box stage lost, read here.
- ``rec_gap``: each served word of a seeded sample of finished pages
  (drawn while the window runs, the page with the most words always in
  it), read by the reference recognizer from the returned page at the returned
  polygon: the widest gap, in nats, by which the served text's CTC
  alignment lies below the reference's best (the smallest such widest gap
  over the alignments, the recognizers the configuration routes between,
  and the two sources a served crop can come from: the wire canvas and the
  full-depth page).
- ``layout_gap`` and ``layout_flips``: the layout model's served tags (the
  argmax of its tag logits) of a seeded sample of forward windows against
  the reference's logits on the same token windows: the widest gap in
  nats, and the share of tokens whose tag is not the reference's.

- any other name: the comparison file ``checks/<name>.py``, which a cell
  adds with no edit here. It names ``CAPTURE``, the program entry
  (``module:function`` or ``module:Class.method``) whose calls in the
  window every run samples, ``KEEP``, the most calls it keeps (a reservoir
  drawn from a stream of its own, ``[seed, 3]``), ``keep(args, kwargs,
  out)``, what it keeps of a call (moved to the host), and ``read(kept,
  ctx, control=None)``, its number after the window (``ctx`` a
  ``CheckContext``; with ``control``, the control's outputs in the
  program's place), computed by a reference of its own under
  ``reference/``; optionally ``FAULTS``, faults in the form of
  ``faults.FAULTS``. A file that is missing, fails to import, or whose
  capture or ``read`` fails reads None, with the error printed.

The control puts the references, computed a precision below the
configurations' bfloat16 (``models.FP8``), in the program's place
(``control``): its outputs go through the same comparisons.
"""

from __future__ import annotations

import re
import sys
import traceback
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from portbench.record import load_reader
from portbench.reference import models as M
from portbench.reference import ops as R

BUILTIN = frozenset({"canvas_px", "det_mad", "det_missed", "rec_gap", "layout_gap",
                     "layout_flips"})
CHECKS = Path(__file__).resolve().parent / "checks"
CHECK_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_\-]{0,63}")

JUDGE_WORDS = 300  # served words the recognition check reads at least
LAYOUT_WINDOWS = 8  # forward windows the layout check reads at most
REC_BATCH = 256


def canvas_px(samples, wire_bits: int) -> int | None:
    """Canvas pixels that differ from the wire quantization of the luma of
    the page the program returned (pages at the canvas's own size)."""
    bad, seen = 0, False
    for s in samples:
        canvas = s.canvas.cpu().numpy()
        for row, page, _ in s.pages:
            if page.shape[:2] != canvas.shape[1:]:
                continue
            seen = True
            bad += int((canvas[row] != R.wire(R.gray(page), wire_bits)).sum())
    return bad if seen else None


def ref_maps(samples, det_sd) -> list:
    """Per sampled wave: its rows, the reference's enhanced canvases and
    its stride-2 maps of them."""
    out = []
    for s in samples:
        rows = sorted({row for row, _, _ in s.pages})
        with torch.no_grad():
            x = R.enhance(s.canvas[rows])
            ref = F.avg_pool2d(M.dbnet_prob(det_sd, x)[:, None], 2)[:, 0]
        out.append((rows, x, ref))
    return out


def det_mad(samples, maps, det_sd, control: M.Precision | None = None) -> float | None:
    """Per page, the mean absolute difference between the served (or, with
    ``control``, the control's) and the reference's stride-2 maps; the
    widest page."""
    worst = None
    for s, (rows, x, ref) in zip(samples, maps):
        with torch.no_grad():
            if control is not None:
                prob = M.dbnet_prob(control.cast(det_sd), x.to(control.dtype), control)
            else:
                prob = s.prob[rows]
            got = F.avg_pool2d(prob.float()[:, None], 2)[:, 0]
        d = float((ref - got).abs().mean(dim=(1, 2)).max())
        worst = d if worst is None else max(worst, d)
    return worst


def det_missed(samples, maps, bin_thresh: float, box_thresh: float) -> float | None:
    """The share of the reference's text regions, over the sampled waves'
    pages, that the words served on those pages leave uncovered (a page
    not served has no words)."""
    regions = missed = 0
    for s, (rows, _, ref) in zip(samples, maps):
        ref = ref.cpu().numpy()
        for row, _, scale in s.pages:
            quads = s.words.get(row, np.zeros((0, 4, 2), np.float32))
            r, m = R.regions_missed(ref[rows.index(row)], quads * (scale / 2.0),
                                    bin_thresh, box_thresh)
            regions += r
            missed += m
    return missed / regions if regions else None


def sample_pages(pool: list, longest, rng: np.random.Generator, words: int = JUDGE_WORDS):
    """The page with the most words, then the window's sampled pages in a
    seeded order until they hold ``words`` words (pages with none among
    them)."""
    if longest is None:
        return []
    out, n = [longest], len(longest[1])
    for i in rng.permutation(len(pool)):
        if n >= words:
            break
        page = pool[int(i)]
        if page is not longest:
            out.append(page)
            n += len(page[1])
    return out


def _logprobs(rec_sd, img_u8: torch.Tensor, plans, prec: M.Precision):
    """Reference log-probabilities (valid frames) of each planned crop."""
    out = [None] * len(plans)
    by_bucket: dict[int, list[int]] = {}
    for i, p in enumerate(plans):
        by_bucket.setdefault(p[0], []).append(i)
    for bucket, idx in by_bucket.items():
        for lo in range(0, len(idx), REC_BATCH):
            part = idx[lo:lo + REC_BATCH]
            crops = R.crop(img_u8, np.stack([plans[i][2] for i in part]),
                           np.array([plans[i][3] for i in part]),
                           np.array([plans[i][1] for i in part]), bucket)
            wv = torch.tensor([plans[i][1] for i in part], device=img_u8.device)
            with torch.no_grad():
                logits, lengths = M.svtr_logits(prec.cast(rec_sd), crops.to(prec.dtype), wv, prec)
                lp = torch.log_softmax(logits.float(), dim=-1).cpu().numpy()
            for k, i in enumerate(part):
                out[i] = lp[k, : int(lengths[k])]
    return out


def rec_gap(pages, rec_sds: dict, buckets, wire_bits: int, device,
            control: M.Precision | None = None, gaps: list | None = None
            ) -> tuple[float | None, int]:
    """The widest gap over the sampled pages' served words (or, with
    ``control``, the control's reads of the same words), and the number of
    words read; ``gaps``, where given, receives every word's gap."""
    worst, n = None, 0
    for quads, texts, page in pages:
        g8 = R.gray(page)
        sources = [torch.from_numpy(np.ascontiguousarray(R.wire(g8, wire_bits))).to(device),
                   torch.from_numpy(np.ascontiguousarray(g8)).to(device)]
        plans = [R.crop_plan(q, tuple(buckets)) for q in quads]
        best = np.full(len(texts), np.inf)
        for name, sd in rec_sds.items():
            chars = R.CHARSETS[name]
            for img in sources:
                ref = _logprobs(sd, img, plans, M.FP32)
                ctl = _logprobs(sd, img, plans, control) if control is not None else None
                for i, text in enumerate(texts):
                    if ctl is not None:
                        text = R.greedy_text(ctl[i], chars)
                    labels = R.encode(text, chars)
                    if labels is not None:
                        best[i] = min(best[i], R.ctc_min_max_gap(ref[i], labels))
        n += len(texts)
        if gaps is not None:
            gaps.extend(best.tolist())
        m = float(best.max()) if len(best) else 0.0
        worst = m if worst is None else max(worst, m)
    return worst, n


def layout_checks(windows, lay_sd, rng: np.random.Generator, device,
                  control: M.Precision | None = None) -> dict:
    """Over a seeded sample of the extractor's forward windows, the served
    tags (or the control's) against the reference's logits: the widest gap
    of a served tag below the reference's best, and the share of tokens
    whose served tag is not the reference's."""
    if not windows:
        return {"layout_gap": None, "layout_flips": None}
    pick = rng.permutation(len(windows))[:LAYOUT_WINDOWS]
    worst, flips, tokens = 0.0, 0, 0
    for i in pick:
        ids, boxes, mask, served = windows[int(i)]
        n = int(mask.sum())
        if n == 0:
            continue

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a[None])).to(device, torch.long)

        with torch.no_grad():
            ref = torch.log_softmax(
                M.layout_tag_logits(lay_sd, dev(ids), dev(boxes), dev(mask)), -1)[0, :n]
            if control is not None:
                tags = M.layout_tag_logits(control.cast(lay_sd), dev(ids), dev(boxes), dev(mask),
                                           control)[0, :n].float().argmax(-1)
            else:
                tags = torch.from_numpy(served[:n].argmax(-1)).to(device)
        gap = ref.max(-1).values - ref.gather(-1, tags[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        flips += int((gap > 0).sum())
        tokens += n
    return {"layout_gap": worst, "layout_flips": flips / tokens if tokens else None}


def check_all(config: dict, weights: dict, settings, det_samples, judged, layout_windows,
              extract: bool, seed: int, device, control: M.Precision | None = None,
              gaps: list | None = None):
    """Every comparison of one run: ({name: number or None}, words read).
    ``judged`` is the window's (sampled pages, page with most words). With
    ``control`` the control's outputs stand in for the program's (it
    serves no words: ``canvas_px`` and ``det_missed`` are the program's
    alone); ``gaps``, where given, receives every read word's gap."""
    M.set_exact_float32()
    rng = np.random.default_rng([seed, 1])
    checks: dict[str, float | None] = {}
    det_sd = M.load_state(weights["det_checkpoint"], device)
    maps = ref_maps(det_samples, det_sd)
    if control is None:
        checks["canvas_px"] = canvas_px(det_samples, settings.det_wire_bits)
        checks["det_missed"] = det_missed(det_samples, maps, settings.det_bin_thresh,
                                          settings.det_box_thresh)
    checks["det_mad"] = det_mad(det_samples, maps, det_sd, control)
    del det_sd, maps
    rec_sds = {name: M.load_state(weights[key], device)
               for name, key in config["recognizers"].items()}
    pages = sample_pages(*judged, rng)
    checks["rec_gap"], n_words = rec_gap(pages, rec_sds, settings.rec_width_buckets,
                                         settings.det_wire_bits, device, control, gaps)
    del rec_sds
    if extract and "extract_checkpoint" in weights:
        lay_sd = M.load_state(weights["extract_checkpoint"], device)
        checks.update(layout_checks(layout_windows, lay_sd, rng, device, control))
    return checks, n_words


# ---- comparison files ----

@dataclass
class CheckContext:
    """What a comparison file's ``read`` has besides its kept calls."""

    config: dict  # the configuration file
    weights: dict  # its weight paths, absolute
    settings: object  # the program's Settings of it
    seed: int
    device: str


def _say(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr)


def load_check(name: str):
    """The module of ``checks/<name>.py``, or None (the error printed)."""
    if not CHECK_NAME.fullmatch(name):
        _say(f"comparison {name!r}: not a name of a comparison file")
        return None
    path = CHECKS / f"{name}.py"
    if not path.is_file():
        _say(f"comparison {name!r}: no file {path}")
        return None
    try:
        mod = load_reader(path)
    except Exception:  # any error of the file's own reads as no number
        _say(f"comparison {name!r}: {path} fails to import\n{traceback.format_exc()}")
        return None
    missing = [a for a in ("CAPTURE", "KEEP", "keep", "read") if not hasattr(mod, a)]
    if missing:
        _say(f"comparison {name!r}: {path} lacks {', '.join(missing)}")
        return None
    return mod


def check_files(names) -> dict:
    """Each name that is not a comparison of this module's own, with its
    file's module or None."""
    return {n: load_check(n) for n in names if n not in BUILTIN}


def read_checks(files: dict, captures: dict, ctx: CheckContext,
                control: M.Precision | None = None) -> dict:
    """Each comparison file's number from its kept calls (``captures``:
    name to ``serve.Capture``), or None with the error printed."""
    out: dict[str, float | None] = {}
    for name, mod in files.items():
        cap = captures.get(name)
        out[name] = None
        if mod is None or cap is None:
            continue
        if cap.error is not None:
            _say(f"comparison {name!r}: {cap.error}")
            continue
        try:
            v = mod.read(cap.kept, ctx, control=control)
            out[name] = None if v is None else float(v)
        except Exception:  # any error of the file's own reads as no number
            _say(f"comparison {name!r}: read failed\n{traceback.format_exc()}")
    return out


def check_faults() -> dict:
    """The ``FAULTS`` of every comparison file there is."""
    out = {}
    for path in sorted(CHECKS.glob("*.py")):
        mod = load_check(path.stem)
        out.update(getattr(mod, "FAULTS", {}) if mod is not None else {})
    return out
