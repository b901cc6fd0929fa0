"""The program's spans and counters (``utils/profiler.SPANS``) on the small
engine of ``test_torch_profiler`` (``SMALL``, with deskew on, the trained
weights of the package, script routing with the Devanagari recognizer, two
pages a wave, one page turned by 3 degrees).

Recording is off without a profiler and on in every thread while one
records (``torch.autograd.profiler._is_profiler_enabled``, the flag all
threads see, where ``torch.autograd._profiler_enabled()`` reads False in a
worker thread); one ``PageScheduler.process`` gives each wave its spans
under one call and wave id across both threads; ``stage_ms`` is read from
the spans' clocks; the spans share the profiler's clock and never enter its
events; the counters equal what the engine dispatched and rescued."""

import concurrent.futures
import json
import threading

import numpy as np
import pytest
import torch

from ocr_system_tpu_torch.core.config import Settings
from ocr_system_tpu_torch.engine.host_image import rotate_cubic
from ocr_system_tpu_torch.engine.pipeline import _build_engine
from ocr_system_tpu_torch.engine.preprocess import PageImage
from ocr_system_tpu_torch.engine.scheduler import PageScheduler
from ocr_system_tpu_torch.ops import device_boxes
from ocr_system_tpu_torch.training import synth_forms
from ocr_system_tpu_torch.utils import profiler
from ocr_system_tpu_torch.utils.profiler import SPANS, Span, SpanLog, self_ns, span
from ocr_system_tpu_torch.utils.smoke import TRAINED
from test_torch_profiler import SMALL

torch.set_num_threads(1)

SPANS_SMALL = {**SMALL, "enable_deskew": True, "rec_charset": "auto", "det_batch_size": 2,
               "det_workers": 1}
TURN_DEG = 3.0
DET_PARTS = ("det.letterbox", "det.forward", "det.turn", "det.emit")


def cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def pages():
    gen = synth_forms.FormGenerator(seed=3)
    out = [(np.asarray(synth_forms.render_spec(gen.generate(256)).image) * 255
            ).round().astype(np.uint8) for _ in range(4)]
    out[1] = rotate_cubic(out[1], TURN_DEG, fill=255)
    return [PageImage(p, i + 1) for i, p in enumerate(out)]


@pytest.fixture(scope="module")
def engine():
    s = Settings(**{**TRAINED, **SPANS_SMALL})
    return _build_engine(s.ocr_engine, s, "cpu")


@pytest.fixture(scope="module")
def scheduled(engine, pages):
    """One warm call, then one traced ``process`` of two waves: its spans,
    the main thread's native id, and the engine's last ``stage_ms``."""
    PageScheduler(engine, engine.settings).process(pages)
    SPANS.clear()
    with cpu_profile():
        PageScheduler(engine, engine.settings).process(pages)
    return list(SPANS.spans), threading.get_native_id(), dict(engine.stage_ms)


def _by_id(spans):
    return {s.id: s for s in spans}


def _ancestors(s, by_id):
    while s.parent in by_id:
        s = by_id[s.parent]
        yield s


def test_nothing_is_recorded_without_a_profiler(engine, pages):
    SPANS.clear()
    assert not torch.autograd.profiler._is_profiler_enabled
    PageScheduler(engine, engine.settings).process(pages)
    assert SPANS.spans == [] and SPANS.anchor is None
    # a timed span keeps its clock all the same
    with profiler.timed("x") as t:
        pass
    assert t.end_ns >= t.start_ns and SPANS.spans == []


def test_the_det_worker_records_under_a_main_thread_profiler(scheduled):
    """The profiler opens in the main thread; the det worker's spans are
    recorded too. This pins the flag the span sites read: a torch whose
    process-wide flag no longer follows the profiler fails here."""
    with cpu_profile():
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            per_thread, process_wide = ex.submit(
                lambda: (torch.autograd._profiler_enabled(),
                         torch.autograd.profiler._is_profiler_enabled)).result()
    assert process_wide and not per_thread
    spans, main, _ = scheduled
    det = [s for s in spans if s.name == "det_stage"]
    assert det and all(s.thread != main for s in det)
    assert {s.thread for s in spans if s.name == "rec_stage"} == {main}


def test_each_wave_has_its_stages_and_the_det_spans_their_ancestor(scheduled):
    spans, _, _ = scheduled
    by_id = _by_id(spans)
    (process,) = [s for s in spans if s.name == "process"]
    waves = sorted({s.wave for s in spans if s.name == "det_stage"})
    assert waves == [0, 1]
    for w in waves:
        for name in ("det_stage", "rec_stage", "det_wait", "rec"):
            assert any(s.name == name and s.wave == w for s in spans), (name, w)
        assert sum(s.name == "det_stage" and s.wave == w for s in spans) == 1
        assert sum(s.name == "rec_stage" and s.wave == w for s in spans) == 1
    det_spans = [s for s in spans if s.name.startswith("det.") or s.name == "device_sync"]
    assert {s.name for s in det_spans} == {*DET_PARTS, "device_sync"}
    for s in det_spans:
        up = [a for a in _ancestors(s, by_id) if a.name == "det_stage"]
        assert len(up) == 1 and (up[0].call, up[0].wave) == (s.call, s.wave) == (
            process.call, s.wave)
    assert all(s.call == process.call for s in spans)
    assert sum(s.counts.get("pages", 0) for s in spans if s.name == "det_stage") == 4
    # the turned page's wave turns it on the host, and re-letterboxes it
    # under the turn
    (turn,) = [s for s in spans if s.name == "det.turn"]
    assert turn.wave == 0
    assert any(s.parent == turn.id and s.name == "det.letterbox" for s in spans)


def test_stage_ms_is_read_from_the_spans(scheduled):
    """The last wave's det and rec stage spans give ``stage_ms``: each key
    the span's duration, ``rec`` its self time (the rescue left out)."""
    spans, _, stage_ms = scheduled
    by_id = _by_id(spans)
    own = self_ns(spans)
    last = max(s.wave for s in spans if s.name == "det_stage")
    for stage, keys in (("det_stage", ("det", "route")),
                        ("rec_stage", ("rec", "rescue", "glue", "finish"))):
        (parent,) = [s for s in spans if s.name == stage and s.wave == last]
        for key in keys:
            (s,) = [x for x in spans if x.name == key and
                    any(a is parent for a in _ancestors(x, by_id))]
            want = own[s.id] if key == "rec" else s.end_ns - s.start_ns
            assert stage_ms[key] == pytest.approx(want / 1e6, abs=1e-6), key
    sched = [s for s in spans if s.name in ("det_wait", "rec") and s.parent in by_id
             and by_id[s.parent].name == "process"]
    assert {s.name for s in sched} == {"det_wait", "rec"}


def test_the_hybrid_detectors_passes_are_spans(pages):
    s = Settings(**{**TRAINED, **SPANS_SMALL, "ocr_engine": "hybrid"})
    eng = _build_engine(s.ocr_engine, s, "cpu")
    eng.det_stage(pages[:2])
    SPANS.clear()
    with cpu_profile():
        eng.det_stage(pages[:2])
    spans = SPANS.spans
    for key in ("det_neural", "det_classical"):
        (x,) = [sp for sp in spans if sp.name == key]
        assert eng.stage_ms[key] == pytest.approx((x.end_ns - x.start_ns) / 1e6, abs=1e-6)
    neural = next(sp for sp in spans if sp.name == "det_neural")
    assert all(any(a is neural for a in _ancestors(sp, _by_id(spans)))
               for sp in spans if sp.name.startswith("det."))


def test_spans_share_the_profilers_clock_and_stay_out_of_its_events(engine, pages):
    SPANS.clear()
    with cpu_profile() as prof:
        with span("probe_host"):
            with torch.profiler.record_function("probe_rf"):
                engine.det_stage(pages[:1])
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    ((host, start, end),) = [x for x in SPANS.on_unix_clock() if x[0].name == "probe_host"]
    probe = events["probe_rf"]
    assert start <= probe.start_ns() <= probe.end_ns() <= end
    assert not {s.name for s in SPANS.spans} & set(events)


def test_counters_equal_what_was_dispatched_and_rescued(engine, pages):
    dets = engine.det_stage(pages)
    quads = sum(len(d.boxes) for d in dets)
    SPANS.clear()
    with cpu_profile():
        engine.rec_stage(pages, dets)
    spans = SPANS.spans
    (rec,) = [s for s in spans if s.name == "rec"]
    (rescue,) = [s for s in spans if s.name == "rescue"]
    assert rec.counts["rec.crops"] == quads > 0
    total = {k: sum(s.counts.get(k, 0) for s in spans) for k in ("rec.crops", "rec.slots")}
    assert total["rec.slots"] >= total["rec.crops"] > 0
    for i, key in enumerate(("rescue.redecoded", "rescue.replaced")):
        assert rescue.counts[key] == sum(v[i] for row in engine.rescued for v in row.values())
    # a rescue re-decodes its crops in one more dispatch
    assert rescue.counts.get("rec.crops", 0) == rescue.counts["rescue.redecoded"]


def test_label_propagation_counts_its_rounds_and_a_silent_stop():
    binary = torch.zeros(1, 16, 16, dtype=torch.bool)
    binary[0, 2:12, 3] = True
    binary[0, 11, 3:14] = True
    SPANS.clear()
    with cpu_profile():
        with span("low"):
            device_boxes.propagate_labels(binary, max_rounds=1)
        with span("default"):
            device_boxes.propagate_labels(binary)
    low, default = (next(s for s in SPANS.spans if s.name == n) for n in ("low", "default"))
    assert low.counts == {"det.label_calls": 1, "det.label_rounds": 1,
                          "det.label_unconverged": 1}
    assert default.counts["det.label_calls"] == 1
    assert "det.label_unconverged" not in default.counts
    syncs = [s for s in SPANS.spans if s.name == "device_sync" and s.parent == default.id]
    assert len(syncs) == default.counts["det.label_rounds"] >= 2


def test_self_time_and_the_cap():
    def mk(i, parent, t0, t1):
        s = Span("s", None)
        s.id, s.parent, s.start_ns, s.end_ns = i, parent, t0, t1
        return s

    spans = [mk(1, 0, 10, 20), mk(2, 0, 30, 35), mk(0, -1, 0, 100), mk(3, 2, 31, 32)]
    assert self_ns(spans) == {0: 85, 1: 10, 2: 4, 3: 1}
    log = SpanLog(cap=2)
    with cpu_profile():
        for _ in range(5):
            with log.span("x"):
                log.count("n", 2)
    assert len(log.spans) == 2 and log.dropped == 3
    assert all(s.counts == {"n": 2} for s in log.spans)
    log.clear()
    assert log.spans == [] and log.dropped == 0 and log.anchor is None


def test_device_trace_writes_the_spans_into_its_chrome_trace(tmp_path):
    SPANS.clear()
    with profiler.device_trace(tmp_path, device="cpu"):
        with span("outer"):
            with torch.profiler.record_function("probe_rf"):
                torch.ones(32, 32) @ torch.ones(32, 32)
            profiler.count("things", 3)
    (path,) = tmp_path.glob("*.json")
    events = json.loads(path.read_text())["traceEvents"]
    (outer,) = [e for e in events if e.get("cat") == "program_span"]
    assert outer["name"] == "outer" and outer["ph"] == "X" and outer["args"]["things"] == 3
    (probe,) = [e for e in events if e.get("name") == "probe_rf"]
    assert outer["tid"] == probe["tid"] and outer["pid"] == probe["pid"]
    assert outer["ts"] <= probe["ts"] and probe["ts"] + probe["dur"] <= outer["ts"] + outer["dur"]
