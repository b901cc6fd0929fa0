"""The system under test and the benchmark's own spans around it.

Builds the served engine (``get_engine``) and, where the mix extracts, the
extraction orchestrator from a configuration file, and drives the measured
window: documents back to back through ``PageScheduler.process`` (closed
loop; with ``document_result`` and ``ExtractionOrchestrator.fields_for``
inside each call where the mix extracts), or uploads at their scheduled
arrivals through ``process``, ``document_result`` and ``fields_for`` (open
loop).

The spans are the benchmark's, around the program's calls, on the engine
instance: each ``det_stage`` and ``rec_stage`` call with the engine's
``stage_ms`` read right after it returns in the calling thread, the
extractor's forward windows, and, for the correctness check, seeded
samples: the detector's device outputs of a few waves with the words
served on their pages, and finished pages (the window keeps no other
pixels). Traced runs also record each launch of the kernels named by a
per-layer metric's ``PROBE``: what its ``LAUNCH`` keeps, or the bytes of
its tensors. Every run records a seeded sample of the calls of each
comparison file's ``CAPTURE`` (``checks/<name>.py``), each as its ``keep``
returns it, on the host.
"""

from __future__ import annotations

import contextlib
import importlib
import inspect
import threading
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

DET_KEYS = ("det", "route", "det_neural", "det_classical")
REC_KEYS = ("rec", "rescue", "glue", "finish")
DET_SAMPLE_WAVES = 2  # waves whose detector outputs the check keeps
JUDGE_PAGES = 32  # finished pages (beside the one with most words) the check may read


def settings_for(config: dict, root: Path, storage: Path):
    """The program's Settings of a configuration file: its settings, its
    weight paths (held to their sha256), storage inside the checkout."""
    from ocr_system_tpu_torch.core.config import Settings

    from portbench.traffic import sha256

    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in config["settings"].items()}
    for key, w in config["weights"].items():
        path = root / w["path"]
        digest = sha256(path)
        if digest != w["sha256"]:
            raise ValueError(f"{w['path']}: sha256 {digest}, the configuration expects {w['sha256']}")
        kw[key] = str(path)
    return Settings(storage_root=str(storage), database_path=str(storage / "bench.db"), **kw)


@dataclass
class DetSample:
    canvas: torch.Tensor  # (B, S, S) uint8, the canvases the recognizer crops
    prob: torch.Tensor  # (B, S, S) float32, the detector's last forward
    pages: list  # (canvas row, processed page, page-to-canvas scale) per page
    # canvas row -> the served word and handwriting polygons (N, 4, 2) of
    # that row's page, filled when the call that served it returns
    words: dict = field(default_factory=dict)


@dataclass
class Served:
    """What one upload or document gave back, as the window keeps it: per
    page its word polygons and shape (no pixels), or None where it failed."""

    pages: list  # per page: (word polygons (N, 4, 2), page shape) or None
    failed: int


def reservoir_slot(kept: int, seen: int, limit: int, rng: np.random.Generator) -> int | None:
    """Where the ``seen``-th item goes in a uniform sample of at most
    ``limit`` that holds ``kept``: the next free place, or a place drawn
    from ``rng`` (one draw), or None where the item is passed over."""
    if kept < limit:
        return kept
    slot = int(rng.integers(seen))
    return slot if slot < limit else None


def _put(pool: list, slot: int, item) -> None:
    if slot == len(pool):
        pool.append(item)
    else:
        pool[slot] = item


def to_host(x):
    """``x`` with every tensor and array in it copied to the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    if type(x) in (list, tuple):
        return type(x)(to_host(v) for v in x)
    return x


@dataclass
class Capture:
    """A comparison file's sample of the calls of its ``CAPTURE``: a
    reservoir of at most ``limit`` calls, each as ``keep(args, kwargs,
    out)`` returns it, moved to the host; ``error`` where the entry could
    not be wrapped or a ``keep`` failed."""

    keep: object
    limit: int
    kept: list = field(default_factory=list)
    seen: int = 0
    error: str | None = None


@dataclass
class Recorder:
    """The benchmark's spans and captures of one run."""

    rng: np.random.Generator
    trace: bool
    # the comparison files' reservoirs draw from a stream of their own,
    # default_rng([keep_seed, 3]), made anew at each reset
    keep_seed: int = 0
    det_calls: list = field(default_factory=list)
    rec_calls: list = field(default_factory=list)
    layout_windows: list = field(default_factory=list)
    det_samples: list = field(default_factory=list)
    probes: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)  # (name, start, end), perf_counter
    det_seen: int = 0
    # the pages the check reads: a uniform sample (reservoir, drawn from
    # the seed) of every finished page, and the page with the most words;
    # each (word polygons, texts, processed page)
    judge_pool: list = field(default_factory=list)
    longest: tuple | None = None
    pages_seen: int = 0
    captures: dict = field(default_factory=dict)  # comparison file name -> Capture
    keep_rng: np.random.Generator | None = None
    local: threading.local = field(default_factory=threading.local)
    lock: threading.Lock = field(default_factory=threading.Lock)
    undo: list = field(default_factory=list)  # (owner, attr, original) per patch

    def __post_init__(self):
        self.keep_rng = np.random.default_rng([self.keep_seed, 3])

    def reset(self, rng: np.random.Generator | None = None,
              keep_seed: int | None = None) -> None:
        """Drop what was recorded (the set-up's calls), keeping the
        wrappers installed."""
        self.det_calls, self.rec_calls, self.layout_windows, self.det_samples = [], [], [], []
        self.spans = []
        self.det_seen = 0
        self.judge_pool, self.longest, self.pages_seen = [], None, 0
        for launches in self.probes.values():
            launches.clear()
        if rng is not None:
            self.rng = rng
        if keep_seed is not None:
            self.keep_seed = keep_seed
        self.keep_rng = np.random.default_rng([self.keep_seed, 3])
        for c in self.captures.values():
            c.kept, c.seen = [], 0

    def _patch(self, owner, attr: str, new) -> None:
        """``setattr(owner, attr, new)``, undone by ``restore``."""
        self.undo.append((owner, attr, vars(owner).get(attr)))
        setattr(owner, attr, new)

    def restore(self) -> None:
        """Put back every attribute the recorder wrapped, of the engine's
        objects, modules and classes."""
        for owner, attr, original in reversed(self.undo):
            if original is None:  # the attribute came from the class
                delattr(owner, attr)
            else:
                setattr(owner, attr, original)
        self.undo = []

    @contextlib.contextmanager
    def span(self, name: str):
        """A host span of the benchmark's own (any thread), which a trace
        reads to name what the host did while the device sat idle."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def install(self, engine, extractor=None, probes: dict | None = None,
                checks: dict | None = None) -> None:
        """Wrap the program: the comparison files' captures (``checks``,
        name to module, None for a file that did not load; first, so that
        a method bound below is the wrapped one), the detector and
        recognizer stages, the layout model's windows, and in a traced
        run the metrics' probes."""
        for name, mod in (checks or {}).items():
            if mod is not None:
                self._capture(name, mod.CAPTURE, mod.keep, mod.KEEP)
        det_stage, rec_stage = engine.det_stage, engine.rec_stage
        dbnet = getattr(engine.detector, "neural", engine.detector).model
        forward = dbnet.forward_nchw

        def forward_nchw(x, *a, **kw):
            out = forward(x, *a, **kw)
            outs = getattr(self.local, "det_outs", None)
            if outs is not None:
                outs.append(out)
            return out

        def det(pages):
            self.local.det_outs = []
            with self.span("det_stage"):
                dets = det_stage(pages)
            outs, self.local.det_outs = self.local.det_outs, None
            ms = engine.stage_ms
            self.det_calls.append({"pages": len(pages),
                                   "ms": {k: ms[k] for k in DET_KEYS if k in ms},
                                   "turned": sum(1 for d in dets
                                                 if getattr(d, "skew_angle", 0.0))})
            self._sample_det(dets, outs)
            return dets

        def rec(pages, dets, *a, **kw):
            with self.span("rec_stage"):
                out = rec_stage(pages, dets, *a, **kw)
            ms = engine.stage_ms
            self.rec_calls.append({"pages": len(pages),
                                   "ms": {k: ms[k] for k in REC_KEYS if k in ms}})
            return out

        self._patch(dbnet, "forward_nchw", forward_nchw)
        self._patch(engine, "det_stage", det)
        self._patch(engine, "rec_stage", rec)
        from ocr_system_tpu_torch.extract.layout_model import LayoutModelExtractor

        # the layout model's windows, which ``layout_gap`` reads; another
        # extractor is left as it is
        if isinstance(extractor, LayoutModelExtractor):
            lay_forward = extractor.forward

            def lay(ids, boxes, mask):
                out = lay_forward(ids, boxes, mask)
                self.layout_windows.append((ids.copy(), boxes.copy(), mask.copy(),
                                            np.asarray(out["tag_logits"]).copy()))
                return out

            self._patch(extractor, "forward", lay)
        if self.trace:
            for spec, summary in (probes or {}).items():
                self._probe(spec, summary)

    def _sample_det(self, dets, outs) -> None:
        """Keep a uniform sample (reservoir, drawn from the seed) of waves:
        the canvases and the probability map of the last forward, where the
        whole wave shares one canvas stack that forward ran on."""
        if not dets or not outs:
            return
        stack = dets[0].canvas_stack
        prob = outs[-1]
        if (not isinstance(stack, torch.Tensor)
                or any(d.canvas_stack is not stack for d in dets)
                or tuple(prob.shape) != tuple(stack.shape)):
            return
        self.det_seen += 1
        slot = reservoir_slot(len(self.det_samples), self.det_seen, DET_SAMPLE_WAVES, self.rng)
        if slot is not None:
            _put(self.det_samples, slot, DetSample(
                stack, prob, [(d.canvas_row, d.page, d.canvas_scale) for d in dets]))

    def served(self, outputs) -> Served:
        """What a call gave back: the window keeps each page's word
        polygons and shape; the check's sample of pages, and the words of
        the sampled detector waves, keep more."""
        words_of = {}
        pages, failed = [], 0
        for o in outputs:
            if not o.success:
                failed += 1
                pages.append(None)
                continue
            words = [b for b in o.layout_boxes if b["type"] == "word"]
            quads = np.array([b["polygon"] for b in words], np.float32).reshape(-1, 4, 2)
            img = o.processed_image
            pages.append((quads, img.shape[:2]))
            # a handwriting box stands for the text under it (the page's
            # words over it leave the layout)
            hand = [b["polygon"] for b in o.layout_boxes if b["type"] == "handwriting"]
            words_of[id(img)] = np.concatenate(
                [quads, np.array(hand, np.float32).reshape(-1, 4, 2)]) if hand else quads
            self._keep((quads, [b["content"] for b in words], img))
        for sample in self.det_samples:
            for row, page, _ in sample.pages:
                if row not in sample.words and id(page) in words_of:
                    sample.words[row] = words_of[id(page)]
        return Served(pages, failed)

    def _keep(self, page) -> None:
        """Reservoir step for one finished page; the page with the most
        words is kept apart."""
        if self.longest is None or len(page[1]) > len(self.longest[1]):
            self.longest = page
        self.pages_seen += 1
        slot = reservoir_slot(len(self.judge_pool), self.pages_seen, JUDGE_PAGES, self.rng)
        if slot is not None:
            _put(self.judge_pool, slot, page)

    def _probe(self, spec: str, summary=None) -> None:
        """Record every call of ``module:attr``: ``summary(args, kwargs,
        out)`` where the metric names one (it keeps what the yardstick
        needs, small), else the bytes of its tensor inputs and output."""
        mod_name, attr = spec.split(":")
        try:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
        except (ImportError, AttributeError):
            return  # the kernel left the path: its metric stays silent
        launches = self.probes.setdefault(spec, [])

        def nbytes(t):
            return t.numel() * t.element_size()

        def probed(*a, **kw):
            out = fn(*a, **kw)
            if summary is not None:
                try:
                    launches.append(summary(a, kw, out))
                except (TypeError, ValueError, IndexError, AttributeError):
                    launches.append(None)  # a call the metric cannot read
            else:
                launches.append({
                    "in_bytes": [nbytes(t) for t in (*a, *kw.values())
                                 if isinstance(t, torch.Tensor)],
                    "out_bytes": nbytes(out) if isinstance(out, torch.Tensor) else 0,
                })
            return out

        self._patch(mod, attr, probed)

    def _capture(self, name: str, spec: str, keep, limit: int) -> None:
        """Sample the calls of ``module:function`` or ``module:Class.method``
        (a method's ``args`` without its instance) into a seeded reservoir.
        The reservoir decides before ``keep`` runs, so a call it passes
        over costs one draw."""
        cap = self.captures[name] = Capture(keep, 0)
        try:
            cap.limit = int(limit)
            mod_name, path = spec.split(":")
            owner = importlib.import_module(mod_name)
            *outer, attr = path.split(".")
            for part in outer:
                owner = getattr(owner, part)
            fn = getattr(owner, attr)
            method = inspect.isclass(owner) and inspect.isfunction(
                inspect.getattr_static(owner, attr))
            if not callable(fn) or (inspect.isclass(owner) and not method):
                raise TypeError(f"{spec} is not a function or a plain method")
        except (ValueError, ImportError, AttributeError, TypeError) as e:
            cap.error = f"CAPTURE {spec!r}: {type(e).__name__}: {e}"
            return

        def captured(*a, **kw):
            out = fn(*a, **kw)
            with self.lock:
                cap.seen += 1
                slot = reservoir_slot(len(cap.kept), cap.seen, cap.limit, self.keep_rng)
                if slot is not None:
                    try:
                        _put(cap.kept, slot, to_host(keep(a[1:] if method else a, kw, out)))
                    except Exception:  # a keep that fails makes the check read nothing
                        cap.error = traceback.format_exc()
            return out

        self._patch(owner, attr, captured)


def build(config: dict, root: Path, extract: bool, device: str):
    """The engine, and the orchestrator where the mix extracts (else None)."""
    from ocr_system_tpu_torch.engine.pipeline import get_engine

    s = settings_for(config, root, root / "build" / "portbench_storage")
    engine = get_engine(s, device=device)
    orch = None
    if extract:
        from ocr_system_tpu_torch.service.orchestrator import ExtractionOrchestrator

        orch = ExtractionOrchestrator(s, engine=engine, device=device)
    return s, engine, orch


def page_images(pages: list[np.ndarray]):
    from ocr_system_tpu_torch.engine.preprocess import PageImage

    return [PageImage(pixels=p, page_number=i + 1) for i, p in enumerate(pages)]


def run_document(engine, settings, pages: list[np.ndarray], rec: Recorder):
    """One ``PageScheduler.process`` call: its outputs and the scheduler's
    waves and stage clocks."""
    from ocr_system_tpu_torch.engine.scheduler import PageScheduler

    sched = PageScheduler(engine, settings)
    with rec.span("process"):
        outs = sched.process(page_images(pages))
    return outs, {"waves": sched.stats.waves, **sched.timer.stages}


def warm_up(engine, settings, orch, flow, rec: Recorder) -> None:
    """One pass over each page set of ``flow.warmup_sets`` (at most two
    waves of each, which reach the pipelined path's worker thread too),
    with ``fields_for`` where the window extracts."""
    from ocr_system_tpu_torch.engine.pipeline import document_result

    for pages in flow.warmup_sets():
        outs, _ = run_document(engine, settings, pages[: 2 * settings.det_batch_size], rec)
        if orch is not None:
            orch.fields_for(document_result(outs))


@dataclass
class Window:
    """What the measured window did."""

    calls: list = field(default_factory=list)  # (start, end, pages) per call
    served: list = field(default_factory=list)  # Served per call
    sched: list = field(default_factory=list)  # scheduler stats per call
    latencies: list = field(default_factory=list)  # seconds, per upload
    lateness: list = field(default_factory=list)  # start past due, idle worker
    extract_ms: list = field(default_factory=list)
    failed_uploads: int = 0
    failed_extracts: int = 0  # closed loop: documents whose fields_for raised
    deadline: float = 0.0
    start: float = 0.0
    end: float = 0.0


def closed_loop(engine, settings, docs: list, seconds: float, rec: Recorder,
                *, orch=None) -> Window:
    """Documents back to back; every call that begins before the deadline
    runs to its end. With ``orch`` (a mix that extracts) each call ends
    once the document's fields are out: ``fields_for`` on its result, in
    the call; a document whose extraction raises counts as failed."""
    from ocr_system_tpu_torch.engine.pipeline import document_result

    w = Window()
    w.start = time.perf_counter()
    w.deadline = w.start + seconds
    k = 0
    while True:
        t0 = time.perf_counter()
        if t0 >= w.deadline:
            break
        doc = docs[k % len(docs)]
        outs, stats = run_document(engine, settings, doc, rec)
        if orch is not None:
            t1 = time.perf_counter()
            try:
                with rec.span("fields_for"):
                    orch.fields_for(document_result(outs))
            except Exception:  # a document that fails is counted, the window goes on
                traceback.print_exc()
                w.failed_extracts += 1
            w.extract_ms.append((time.perf_counter() - t1) * 1000.0)
        w.calls.append((t0, time.perf_counter(), len(doc)))
        w.served.append(rec.served(outs))
        w.sched.append(stats)
        k += 1
    w.end = w.calls[-1][1]
    return w


def open_loop(engine, settings, orch, uploads: list, seconds: float, rec: Recorder,
              drain_s: float = 60.0) -> Window:
    """Uploads served one at a time in arrival order, each from its
    scheduled arrival (the service serialises OCR): OCR, the document,
    then ``fields_for``. Uploads due in the window that are still queued
    when it closes are served after it, for up to ``drain_s``; one not
    served by then counts as failed."""
    from ocr_system_tpu_torch.engine.pipeline import document_result

    w = Window()
    w.start = time.perf_counter()
    w.deadline = w.start + seconds
    for u in uploads:
        due = w.start + u.due_s
        now = time.perf_counter()
        if now > w.deadline + drain_s:
            w.failed_uploads += 1
            continue
        if now < due:
            with rec.span("idle"):
                time.sleep(due - now)
            w.lateness.append(time.perf_counter() - due)
        t0 = time.perf_counter()
        try:
            outs, stats = run_document(engine, settings, u.pages, rec)
            t1 = time.perf_counter()
            with rec.span("fields_for"):
                orch.fields_for(document_result(outs))
        except Exception:  # an upload that fails is counted, the window goes on
            traceback.print_exc()
            w.failed_uploads += 1
            continue
        done = time.perf_counter()
        w.calls.append((t0, done, len(u.pages)))
        w.served.append(rec.served(outs))
        w.sched.append(stats)
        w.extract_ms.append((done - t1) * 1000.0)
        w.latencies.append(done - due)
    w.end = time.perf_counter()
    return w
