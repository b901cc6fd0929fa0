"""The check that decides ``correct``, driven through a whole run on the
CPU (the harness's look for a card skipped) at a size a test holds: a sound
run passes the committed limits; the float8 control fails one of them;
and with the timed path broken underneath, ``correct`` comes out false for
each fault the cells can have: an answer altered where it is produced (a
served text, the detector's canvas or map, the layout model's tags) and
half of the batch left out (every other crop's decode dropped, every other
box dropped, every other page served empty); the faults are
``portbench/faults.py``'s.

The program runs its plain kernels on the CPU; the card runs the control
at the cells' own sizes (``tools/calibrate.py``, readings in PERF.md).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import faults, judge, run, serve, traffic
from portbench.reference import models as M

BACKLOG = "neural_latin_bf16.sparse_pages.backlog"
FORMS = "hybrid_serving_bf16.latin_forms.backlog"
# an upload cell of the served configuration (no such cell is in the
# benchmark yet; PERF.md says why): the open loop, the layout model and
# its check, with limits for this test
UPLOADS = "hybrid_serving_bf16.uploads.test"
UPLOAD_MIX = json.loads((Path(__file__).parent / "mixed_uploads.json").read_text())
UPLOAD_LIMITS = {"canvas_px": 0, "det_mad": 0.00024, "det_missed": 0.15, "rec_gap": 0.6,
                 "layout_gap": 0.5, "layout_flips": 0.01}


@pytest.fixture
def tiny(monkeypatch):
    """The cells with their traffic cut to a few pages, each run on an
    engine of its own (``get_engine`` keeps one per settings)."""
    from ocr_system_tpu_torch.engine import pipeline

    monkeypatch.setattr(pipeline, "_ENGINES", {})
    real = run._cell

    def cell(name):
        if name == BACKLOG:
            bench, c, config, _, limits = real(name)
            mix = {"loop": "closed", "doc_pages": 2, "documents": 1,
                   "pages": {"kind": "glyph", "size": 960, "rows": 4, "pool": 2}}
            return bench, c, config, mix, limits
        bench, c, config, _, _ = real(FORMS)
        mix = {**UPLOAD_MIX, "rate_per_s": 3.0, "upload_pages": [[1, 1.0]],
               "sources": [{**UPLOAD_MIX["sources"][0], "share": 1.0}]}
        return bench, {**c, "name": name}, config, mix, UPLOAD_LIMITS

    monkeypatch.setattr(run, "_cell", cell)
    torch.manual_seed(0)


def _run(name, seconds=0.1, seed=2**31 + 5):
    code, result = run.run_cell(name, seed, seconds, False, device="cpu")
    assert code == 0 and result is not None
    return result


@pytest.mark.parametrize("name,seconds", [(BACKLOG, 0.1), (UPLOADS, 1.0)])
def test_a_sound_run_is_correct(tiny, name, seconds):
    r = _run(name, seconds)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    if name == UPLOADS:
        assert "layout_gap" in r["checks"]


@pytest.mark.parametrize("name,fault,seconds,caught_by", [
    (BACKLOG, "text_altered", 0.1, "rec_gap"),
    (BACKLOG, "decodes_dropped", 0.1, "rec_gap"),
    (BACKLOG, "boxes_dropped", 0.1, "det_missed"),
    (BACKLOG, "pages_emptied", 0.1, "det_missed"),
    (BACKLOG, "map_mirrored", 0.1, "det_missed"),
    (UPLOADS, "map_mirrored", 1.0, "det_mad"),
    (BACKLOG, "canvas_altered", 0.1, "canvas_px"),
    (UPLOADS, "tags_altered", 1.0, "layout_gap"),
], ids=["text_altered", "half_dropped", "boxes_dropped", "pages_emptied", "map_altered",
        "map_altered_mad", "canvas_altered", "tags_altered"])
def test_a_fault_underneath_makes_the_run_incorrect(tiny, monkeypatch, name, fault, seconds,
                                                    caught_by):
    faults.FAULTS[fault](monkeypatch.setattr)
    r = _run(name, seconds)
    assert not r["correct"]
    assert r["checks"][caught_by]["value"] > run._cell(name)[4][caught_by], r["checks"]


def test_the_control_fails_the_limits(tiny):
    """The references a precision below bfloat16 (float8 products) in the
    program's place, on what a short window served: the recognition gap is
    past its limit."""
    _, _, config, mix, limits = run._cell(BACKLOG)
    settings, engine, _ = serve.build(config, run.ROOT, False, "cpu")
    rec = serve.Recorder(np.random.default_rng(0), False)
    rec.install(engine)
    flow = traffic.generate(mix, 11, 0.1, run.ROOT)
    w = serve.closed_loop(engine, settings, flow.documents, 0.1, rec)
    weights = {k: str(run.ROOT / v["path"]) for k, v in config["weights"].items()}
    checks, n = judge.check_all(config, weights, settings, rec.det_samples,
                                (rec.judge_pool, rec.longest), rec.layout_windows, False, 11,
                                "cpu", M.FP8)
    assert n > 0
    assert checks["rec_gap"] > limits["rec_gap"], json.dumps(checks)
