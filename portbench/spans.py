"""What the readers of the program's own spans share: the program's span
log (``ocr_system_tpu_torch.utils.profiler.SPANS``: spans with a name, id,
parent, start and end on ``time.perf_counter_ns`` and counts) cut to the
run's window, self times, and per-page shares over the pages of the
window's ``det_stage`` spans. A program without the log reads None, and so
does a window in which it recorded nothing: the metric stays silent.

Self time (a span's duration less its children's) is worked out here and
not with the program's helper, so that the yardstick does not move when
the program's code does."""

from __future__ import annotations


def in_window(run) -> list | None:
    """The log's spans that lie inside the run's window, or None."""
    try:
        from ocr_system_tpu_torch.utils.profiler import SPANS
    except ImportError:
        return None
    lo, hi = run.window.start * 1e9, run.window.end * 1e9
    spans = [s for s in list(SPANS.spans) if lo <= s.start_ns and s.end_ns <= hi]
    return spans or None


def self_ns(spans: list) -> dict:
    out = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def total(spans: list, key: str, name: str | None = None) -> int:
    """The sum of counter ``key`` over the spans (of ``name``, if given)."""
    return sum(s.counts.get(key, 0) for s in spans if name is None or s.name == name)


def ms_per_page(run, name: str, own: bool = True, under: str | None = None) -> float | None:
    """The self time (``own``) or the duration of the window's ``name``
    spans (those with an ancestor ``under``, if given), in ms per page of
    the window's ``det_stage`` spans."""
    spans = in_window(run)
    if spans is None:
        return None
    pages = total(spans, "pages", "det_stage")
    if not pages:
        return None
    times = self_ns(spans) if own else {s.id: s.end_ns - s.start_ns for s in spans}
    by_id = {s.id: s for s in spans}

    def has_ancestor(s) -> bool:
        while s.parent in by_id:
            s = by_id[s.parent]
            if s.name == under:
                return True
        return False

    ns = sum(times[s.id] for s in spans
             if s.name == name and (under is None or has_ancestor(s)))
    return ns / 1e6 / pages
