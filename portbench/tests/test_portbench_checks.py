"""A comparison of a model's own, added by new files only, and closed
loops that extract, on the CPU (the harness's look for a card skipped):

- ``example/`` holds a comparison file (``checks/layout_tag_gap.py``: its
  capture, reservoir, ``keep``, ``read`` and a planted fault), its
  reference (``reference/layout_tags.py``), a closed mix that extracts
  (``traffic/forms_extract.json``) and the cell's limits;
  ``example_checkout`` adds them to a copy of the benchmark as new files
  and entries. The check decides ``correct``, its fault fails it, and
  ``tools/calibrate.py`` reads it on the program's side and the control's.
- A closed mix that extracts calls ``fields_for`` once a document, inside
  the timed call.
- A comparison file draws from its own stream: the sparse cell's detector
  samples and judged pages are the same with and without one.
- A comparison whose file is missing or fails to import reads None, and
  the run is not correct.
- The layout capture wraps the layout model only: an extractor with a
  ``forward`` of another signature is left as it is.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import judge, run, serve, traffic

ROOT = Path(__file__).resolve().parents[2]
EXAMPLE = Path(__file__).parent / "example"
CELL = "hybrid_serving_bf16.forms_extract.backlog"
CHECK = "layout_tag_gap"
SPARSE = "neural_latin_bf16.sparse_pages.backlog"
FORMS_CONFIG = json.loads((ROOT / "portbench" / "configs" / "hybrid_serving_bf16.json")
                          .read_text())


def example_checkout(dest: Path) -> dict:
    """A copy of the benchmark in ``dest`` (the program linked in) with the
    example cell added as new files and entries in ``BENCHMARK.json``; the
    bytes of every file of the copy's ``portbench/`` before."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "ocr_system_tpu_torch").symlink_to(ROOT / "ocr_system_tpu_torch")
    before = {p: p.read_bytes() for p in (dest / "portbench").rglob("*") if p.is_file()}
    for src in (EXAMPLE / "checks" / f"{CHECK}.py", EXAMPLE / "reference" / "layout_tags.py",
                EXAMPLE / "traffic" / "forms_extract.json",
                EXAMPLE / "limits" / f"{CELL}.json"):
        to = dest / "portbench" / src.relative_to(EXAMPLE)
        assert not to.exists(), to
        to.parent.mkdir(exist_ok=True)
        shutil.copy(src, to)
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": CELL, "config": "hybrid_serving_bf16", "traffic": "forms_extract", "chips": 1,
        "why": "2-page form documents back to back, each through to its fields"})
    next(m for m in bench["end_to_end"] if m["name"] == "pages_per_s")["workloads"].append(CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return before


def _python(args: list[str], cwd: Path) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(cwd), "CUDA_VISIBLE_DEVICES": ""}
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=600)


RUNS = f"""
import json
from portbench import judge, run
path = run.ROOT / "portbench" / "limits" / "{CELL}.json"
limits = json.loads(path.read_text())


def once():
    code, r = run.run_cell("{CELL}", 2**31 + 7, 0.1, False, device="cpu")
    assert code == 0
    return r


sound = once()
path.write_text(json.dumps({{**limits, "{CHECK}": sound["checks"]["{CHECK}"]["value"] - 1e-3}}))
tight = once()
path.write_text(json.dumps(limits))
judge.check_faults()["tags_negated"](setattr)
print(json.dumps([sound, tight, once()]))
"""


def test_a_comparison_is_added_by_new_files_only(tmp_path):
    before = example_checkout(tmp_path)
    limit = json.loads((EXAMPLE / "limits" / f"{CELL}.json").read_text())[CHECK]

    out = _python(["-c", RUNS], tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]
    sound, tight, fault = json.loads(out.stdout.strip().splitlines()[-1])
    assert sound["correct"], sound["checks"]
    assert sound["checks"][CHECK]["value"] <= limit
    assert not tight["correct"]  # the same reading against a limit just under it
    assert not fault["correct"] and fault["checks"][CHECK]["value"] > limit, fault["checks"]
    assert f"check {CHECK} " in out.stderr  # beside its limit on standard error

    out = _python(["-m", "portbench.tools.calibrate", "--config",
                   "portbench/configs/hybrid_serving_bf16.json", "--mix",
                   "portbench/traffic/forms_extract.json", "--seeds", "1", "--control-seeds",
                   "1", "--seconds", "0.1", "--first-seed", "5", "--device", "cpu",
                   "--check", CHECK], tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]
    sides = {r["side"]: r["checks"] for r in map(json.loads, out.stdout.strip().splitlines())}
    assert set(sides) == {"program", "control"}
    assert sides["program"][CHECK] <= limit and sides["control"][CHECK] is not None, sides

    out = _python(["-m", "portbench.tools.calibrate", "--help"], tmp_path)
    assert "tags_negated" in out.stdout  # --fault takes the file's faults

    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_a_closed_mix_that_extracts_calls_fields_for_once_a_document(monkeypatch):
    from ocr_system_tpu_torch.engine import pipeline

    monkeypatch.setattr(pipeline, "_ENGINES", {})
    mix = json.loads((EXAMPLE / "traffic" / "forms_extract.json").read_text())
    settings, engine, orch = serve.build(FORMS_CONFIG, ROOT, True, "cpu")
    flow = traffic.generate(mix, 3, 0.1, ROOT)
    assert flow.extract
    stamps = []
    real = orch.fields_for

    def fields_for(doc, *a, **kw):
        t0 = time.perf_counter()
        out = real(doc, *a, **kw)
        stamps.append((t0, time.perf_counter(), doc.total_pages))
        return out

    monkeypatch.setattr(orch, "fields_for", fields_for)
    rec = serve.Recorder(np.random.default_rng(0), False)
    rec.install(engine, orch.extractor)
    w = serve.closed_loop(engine, settings, flow.documents, 0.1, rec, orch=orch)
    assert len(stamps) == len(w.calls) == len(w.extract_ms) >= 1
    for (c0, c1, pages), (f0, f1, doc_pages) in zip(w.calls, stamps):
        assert c0 < f0 < f1 <= c1 and doc_pages == pages == mix["doc_pages"]
    assert sum(1 for s in rec.spans if s[0] == "fields_for") == len(w.calls)
    assert w.failed_extracts == 0 and rec.layout_windows

    # without the orchestrator, as the backlogs run: nothing new is called
    w = serve.closed_loop(engine, settings, flow.documents, 0.1, rec)
    assert len(stamps) == 1 and w.extract_ms == []


@pytest.fixture
def sparse_tiny(monkeypatch, tmp_path):
    """The sparse cell at 2 waves of 2 pages, its reservoirs cut to one
    wave and one page so that both draw; comparison files from
    ``tmp_path``; the readings ``check_all`` was handed, and the
    recorders."""
    from ocr_system_tpu_torch.engine import pipeline

    monkeypatch.setattr(pipeline, "_ENGINES", {})
    monkeypatch.setattr(serve, "DET_SAMPLE_WAVES", 1)
    monkeypatch.setattr(serve, "JUDGE_PAGES", 1)
    monkeypatch.setattr(judge, "CHECKS", tmp_path)
    extra: dict = {}
    real_cell = run._cell

    def cell(name):
        bench, c, config, _, limits = real_cell(SPARSE)
        config = {**config, "settings": {**config["settings"], "det_batch_size": 2}}
        mix = {"loop": "closed", "doc_pages": 4, "documents": 1,
               "pages": {"kind": "glyph", "size": 960, "rows": 4, "pool": 4}}
        return bench, c, config, mix, {**limits, **extra}

    monkeypatch.setattr(run, "_cell", cell)
    seen = types.SimpleNamespace(judged=[], recorders=[], extra=extra)
    real_check_all, real_recorder = judge.check_all, serve.Recorder

    def check_all(config, weights, settings, det_samples, judged, *a, **kw):
        seen.judged.append((det_samples, judged))
        return real_check_all(config, weights, settings, det_samples, judged, *a, **kw)

    def recorder(*a, **kw):
        seen.recorders.append(real_recorder(*a, **kw))
        return seen.recorders[-1]

    monkeypatch.setattr(judge, "check_all", check_all)
    monkeypatch.setattr(serve, "Recorder", recorder)
    torch.manual_seed(0)
    return seen


COUNT_CHECK = '''
CAPTURE = "ocr_system_tpu_torch.models.dbnet:DBNet.forward_nchw"
KEEP = 1


def keep(args, kwargs, out):
    return args[0].shape, out


def read(kept, ctx, control=None):
    return float(len(kept))
'''


def test_a_comparison_file_leaves_the_cells_samples_as_they_are(sparse_tiny, tmp_path):
    seed = 2**31 + 99
    code, plain = run.run_cell(SPARSE, seed, 0.1, False, device="cpu")
    assert code == 0 and plain["correct"], plain["checks"]
    (tmp_path / "dbnet_calls.py").write_text(COUNT_CHECK)
    sparse_tiny.extra["dbnet_calls"] = 1.0
    code, with_file = run.run_cell(SPARSE, seed, 0.1, False, device="cpu")
    assert code == 0 and with_file["correct"], with_file["checks"]
    assert with_file["checks"]["dbnet_calls"]["value"] == 1.0  # its reservoir kept one call
    a, b = sparse_tiny.recorders
    cap = b.captures["dbnet_calls"]
    assert cap.seen >= 2 and len(cap.kept) == 1  # the reservoir drew
    assert a.rng.bit_generator.state == b.rng.bit_generator.state
    (det_a, (pool_a, longest_a)), (det_b, (pool_b, longest_b)) = sparse_tiny.judged
    assert plain["attempted"] == with_file["attempted"] == 4
    assert len(det_a) == len(det_b) == 1 and len(pool_a) == len(pool_b) == 1
    for x, y in zip(det_a, det_b):
        assert torch.equal(x.prob, y.prob) and torch.equal(x.canvas, y.canvas)
        assert [r for r, _, _ in x.pages] == [r for r, _, _ in y.pages]
    for x, y in zip([*pool_a, longest_a], [*pool_b, longest_b]):
        assert np.array_equal(x[0], y[0]) and x[1] == y[1] and np.array_equal(x[2], y[2])
    assert plain["checks"]["rec_gap"] == with_file["checks"]["rec_gap"]


@pytest.mark.parametrize("body,error", [
    (None, "no file"),
    ("import no_such_module_here\n", "fails to import"),
    ("CAPTURE = 'ocr_system_tpu_torch.models.dbnet:NoSuchClass.forward'\nKEEP = 1\n"
     "def keep(a, kw, out):\n    return 0\ndef read(kept, ctx, control=None):\n    return 0.0\n",
     "NoSuchClass"),
], ids=["missing", "fails_to_import", "capture_not_found"])
def test_a_comparison_that_cannot_read_makes_the_run_incorrect(sparse_tiny, tmp_path, capsys,
                                                               body, error):
    if body is not None:
        (tmp_path / "broken.py").write_text(body)
    sparse_tiny.extra["broken"] = 1.0
    code, r = run.run_cell(SPARSE, 2**31 + 3, 0.1, False, device="cpu")
    assert code == 0 and not r["correct"]
    assert r["checks"]["broken"]["value"] is None
    err = capsys.readouterr().err
    assert error in err and "check broken None limit 1.0" in err


def test_the_reservoir_keeps_a_seeded_sample_on_the_host(monkeypatch):
    mod = types.ModuleType("portbench_test_entry")
    mod.entry = lambda x, scale=1: x * scale
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    checks = types.SimpleNamespace(CAPTURE=f"{mod.__name__}:entry", KEEP=3,
                                   keep=lambda a, kw, out: {"x": a[0], "out": out, "kw": kw})

    def sample(seed):
        rec = serve.Recorder(np.random.default_rng(0), False, keep_seed=seed)
        rec._capture("c", checks.CAPTURE, checks.keep, checks.KEEP)
        rng_state = rec.rng.bit_generator.state
        outs = [mod.entry(torch.full((2,), float(i)), scale=2) for i in range(50)]
        assert rec.rng.bit_generator.state == rng_state  # the run's own stream untouched
        cap = rec.captures["c"]
        rec.restore()
        return outs, cap

    outs, cap = sample(7)
    assert torch.equal(outs[5], torch.full((2,), 10.0))  # the program's answer unchanged
    assert cap.seen == 50 and len(cap.kept) == 3 and cap.error is None
    xs = [int(k["x"][0]) for k in cap.kept]
    assert all(k["kw"] == {"scale": 2} and k["x"].device.type == "cpu" for k in cap.kept)
    assert all(torch.equal(k["out"], 2 * k["x"]) for k in cap.kept)
    assert xs == [int(k["x"][0]) for k in sample(7)[1].kept]  # fixed by the seed
    assert any(x >= 3 for x in xs)  # later calls replace early ones
    assert mod.entry(1) == 1 and not hasattr(mod.entry, "__wrapped__")  # restored


class _StubExtractor:
    """An extractor with a ``forward`` of its own signature."""

    name = "stub"

    def __init__(self):
        self.calls = []

    def forward(self, x):
        self.calls.append(x)
        return 2 * x

    def extract(self, ocr_text, line_confidences=None, template=None, custom_prompt=None):
        from ocr_system_tpu_torch.extract.rules import RuleExtractor

        assert self.forward(len(ocr_text)) == 2 * len(ocr_text)
        return RuleExtractor().extract(ocr_text, line_confidences, template, custom_prompt)


def test_an_extractor_that_is_not_the_layout_model_runs_unharmed(monkeypatch):
    from ocr_system_tpu_torch.engine import pipeline
    from ocr_system_tpu_torch.service.orchestrator import ExtractionOrchestrator

    monkeypatch.setattr(pipeline, "_ENGINES", {})
    settings, engine, _ = serve.build(FORMS_CONFIG, ROOT, False, "cpu")
    stub = _StubExtractor()
    orch = ExtractionOrchestrator(settings, engine=engine, extractor=stub, device="cpu")
    mix = json.loads((Path(__file__).parent / "mixed_uploads.json").read_text())
    mix = {**mix, "rate_per_s": 3.0, "upload_pages": [[1, 1.0]],
           "sources": [{**mix["sources"][0], "share": 1.0}]}
    flow = traffic.generate(mix, 5, 0.5, ROOT)
    rec = serve.Recorder(np.random.default_rng(0), False)
    rec.install(engine, orch.extractor)
    w = serve.open_loop(engine, settings, orch, flow.uploads, 0.5, rec)
    assert flow.uploads and w.failed_uploads == 0
    assert len(stub.calls) == len(w.latencies) == len(flow.uploads)
    assert orch.extractor.forward.__func__ is _StubExtractor.forward
    assert rec.layout_windows == []
