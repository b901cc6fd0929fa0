"""The readers of the classical pass's spans (``classical.skew``,
``classical.mask``) on a synthetic span log: known self times give known
values per page, spans outside the window are left out, and a log that is
empty, absent, or without the reader's span (a program that does not
record it) reads None.

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
LATE = 1_500_000_000

SPAN = {"det_classical_skew_ms_per_page": "classical.skew",
        "det_classical_mask_ms_per_page": "classical.mask"}
WANT = {"det_classical_skew_ms_per_page": 6 / 4,
        "det_classical_mask_ms_per_page": 12 / 4}


def reader(name):
    return record.load_reader(ROOT / "portbench" / "metrics" / f"{name}.py")


def log():
    """One wave of 4 pages inside a window that ends at 1.4 s, and one of
    100 pages after it; each classical pass holds its skew search, a turn
    and its ink mask, and the mask a child span of its own."""
    spans = []

    def add(i, name, parent, start_ms, dur_ms, base=T0, **counts):
        spans.append(SimpleNamespace(id=i, name=name, parent=parent,
                                     start_ns=base + start_ms * MS,
                                     end_ns=base + (start_ms + dur_ms) * MS, counts=counts))

    add(0, "det_stage", -1, 0, 100, pages=4)
    add(1, "det", 0, 0, 95)
    add(2, "det_neural", 1, 0, 60)
    add(3, "det_classical", 1, 60, 35)
    add(4, "classical.skew", 3, 60, 6, **{"skew.pages": 1})
    add(5, "classical.turn", 3, 66, 2)
    add(6, "classical.mask", 3, 70, 15)
    add(7, "device_sync", 6, 75, 3)
    add(20, "det_stage", -1, 0, 100, base=LATE, pages=100)
    add(21, "det_classical", 20, 0, 40, base=LATE)
    add(22, "classical.skew", 21, 0, 20, base=LATE)
    add(23, "classical.mask", 21, 20, 10, base=LATE)
    return spans


def run_of(end_s=2.0):
    return SimpleNamespace(window=SimpleNamespace(start=1.0, end=end_s))


@pytest.fixture
def program_log(monkeypatch):
    from ocr_system_tpu_torch.utils import profiler

    fake = SimpleNamespace(spans=log())
    monkeypatch.setattr(profiler, "SPANS", fake)
    return fake


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_reads_its_spans_self_time_per_page(program_log, name):
    assert reader(name).read(run_of(1.4)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_leaves_out_spans_outside_the_window(program_log, name):
    assert reader(name).read(run_of(2.0)) != pytest.approx(WANT[name])
    program_log.spans = [s for s in program_log.spans if s.id < 20]
    assert reader(name).read(run_of(2.0)) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_of_a_log_without_its_span_reads_none(program_log, name):
    program_log.spans = [s for s in program_log.spans if s.name != SPAN[name]]
    assert any(s.name == "det_stage" for s in program_log.spans)
    assert reader(name).read(run_of(1.4)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_of_an_empty_or_absent_log_reads_none(monkeypatch, program_log, name):
    program_log.spans = []
    assert reader(name).read(run_of()) is None
    from ocr_system_tpu_torch.utils import profiler

    monkeypatch.delattr(profiler, "SPANS")
    assert reader(name).read(run_of()) is None
