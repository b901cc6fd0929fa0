"""The readers of the program's spans and counters on a synthetic span log:
known self times and counts give known values, spans outside the window
are left out, and an empty or absent log reads None.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import record

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000
T0 = 1_100_000_000  # ns on perf_counter; the window is [1 s, 2 s]


def reader(name):
    return record.load_reader(ROOT / "portbench" / "metrics" / f"{name}.py")


def log():
    """One wave of 4 pages inside the window, and one of 100 pages after it."""
    spans = []

    def add(i, name, parent, start_ms, dur_ms, base=T0, **counts):
        spans.append(SimpleNamespace(id=i, name=name, parent=parent,
                                     start_ns=base + start_ms * MS,
                                     end_ns=base + (start_ms + dur_ms) * MS, counts=counts))

    add(0, "det_stage", -1, 0, 100, pages=4)
    add(1, "det", 0, 0, 60)
    add(2, "det.letterbox", 1, 0, 10)
    add(3, "det.forward", 1, 10, 30, **{"det.label_calls": 2, "det.label_rounds": 10})
    add(4, "device_sync", 3, 15, 20)
    add(5, "det.turn", 1, 40, 8)
    add(6, "det.letterbox", 5, 42, 2)
    add(7, "det.emit", 1, 50, 5)
    add(8, "route", 0, 60, 4)
    add(9, "rec_stage", -1, 200, 50, pages=4)
    add(10, "rec", 9, 200, 40, **{"rec.crops": 30, "rec.slots": 40})
    add(11, "rescue", 10, 220, 10, **{"rec.crops": 6, "rec.slots": 8, "rescue.redecoded": 6})
    add(12, "device_sync", 10, 210, 1)
    late = 1_500_000_000
    add(20, "det_stage", -1, 0, 100, base=late, pages=100)
    add(21, "det.letterbox", 20, 0, 50, base=late)
    add(22, "det.forward", 20, 50, 10, base=late,
        **{"det.label_calls": 1, "det.label_rounds": 64})
    add(23, "device_sync", 22, 51, 5, base=late)
    add(24, "rec", -1, 200, 10, base=late, **{"rec.crops": 10, "rec.slots": 10})
    return spans


WANT = {
    "det_letterbox_ms_per_page": 12 / 4,
    "det_forward_ms_per_page": 10 / 4,
    "det_sync_ms_per_page": 20 / 4,
    "det_turn_ms_per_page": 6 / 4,
    "det_emit_ms_per_page": 5 / 4,
    "route_ms_per_page": 4 / 4,
    "label_rounds_per_forward": 10 / 2,
    "rec_pad_share": 100 * (1 - 36 / 48),
    "rescue_share": 100 * 6 / 30,
}


def run_of(end_s=2.0):
    return SimpleNamespace(window=SimpleNamespace(start=1.0, end=end_s))


@pytest.fixture
def program_log(monkeypatch):
    from ocr_system_tpu_torch.utils import profiler

    fake = SimpleNamespace(spans=log())
    monkeypatch.setattr(profiler, "SPANS", fake)
    return fake


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_synthetic_log(program_log, name):
    assert reader(name).read(run_of(1.4)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_leaves_out_spans_outside_the_window(program_log, name):
    # a window that holds the second wave too reads differently
    wide = reader(name).read(run_of(2.0))
    assert wide != pytest.approx(WANT[name])
    program_log.spans = [s for s in program_log.spans if s.id < 20]
    assert reader(name).read(run_of(2.0)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_of_an_empty_or_absent_log_reads_none(monkeypatch, program_log, name):
    program_log.spans = []
    assert reader(name).read(run_of()) is None
    from ocr_system_tpu_torch.utils import profiler

    monkeypatch.delattr(profiler, "SPANS")
    assert reader(name).read(run_of()) is None
