"""The benchmark's own parts on the CPU: cells load from data, traffic is
fixed by the seed, the yardstick's arithmetic, and what the harness
imports.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import judge, record, run, traffic, yardstick as Y

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
ALL_CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_file_keeps_to_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", ALL_CELLS)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(ALL_CELLS)


@pytest.mark.parametrize("cell", ALL_CELLS)
def test_each_cell_loads_from_data(cell):
    bench, c, config, mix, limits = run._cell(cell)
    assert config["recognizers"] and config["weights"]
    assert {"canvas_px", "det_missed", "rec_gap"} <= set(limits)
    # a name is one of judge.py's own comparisons or a comparison file
    assert judge.BUILTIN == {"canvas_px", "det_mad", "det_missed", "rec_gap", "layout_gap",
                             "layout_flips"}
    for name in set(limits) - judge.BUILTIN:
        assert (ROOT / "portbench" / "checks" / f"{name}.py").is_file(), name
    # the layout model's check where the mix extracts with it
    layout = (config["settings"].get("extraction_method", "auto") in ("auto", "layout_model")
              and "extract_checkpoint" in config["weights"])
    assert ("layout_flips" in limits) == bool(mix.get("extract") and layout)
    reported = {m["name"] for m in run._metrics(bench, c, False)}
    assert "setup_s" in reported and len(reported) >= 2
    layer = run._metrics(bench, c, True)
    assert layer
    for m in layer:
        reader = record.load_reader(ROOT / "portbench" / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)


@pytest.mark.parametrize("mix", ["traffic/glyph_pages", "traffic/sparse_pages",
                                 "traffic/latin_forms", "tests/mixed_uploads"])
def test_traffic_is_fixed_by_the_seed(mix):
    spec = json.loads((ROOT / "portbench" / f"{mix}.json").read_text())
    seed = 2**31 + 12345
    a = traffic.generate(spec, seed, 20.0, ROOT)
    b = traffic.generate(spec, seed, 20.0, ROOT)
    c = traffic.generate(spec, seed + 1, 20.0, ROOT)

    def pages(t):
        return ([p for d in t.documents for p in d]
                + [p for u in t.uploads for p in u.pages])

    assert all(np.array_equal(x, y) for x, y in zip(pages(a), pages(b)))
    assert [u.due_s for u in a.uploads] == [u.due_s for u in b.uploads]
    assert not all(np.array_equal(x, y) for x, y in zip(pages(a), pages(c)))
    # every seed offers the same load: the arrival schedule is fixed
    assert [(u.due_s, len(u.pages), u.source) for u in a.uploads] == \
        [(u.due_s, len(u.pages), u.source) for u in c.uploads]


def test_every_seed_gets_the_same_ink():
    spec = json.loads((ROOT / "portbench" / "traffic" / "glyph_pages.json").read_text())
    ink = [sum(int((p < 128).sum()) for p in traffic.generate(spec, s, 1.0, ROOT).documents[0])
           for s in (1, 2, 3)]
    assert max(ink) / min(ink) < 1.03


def test_rate_counts_the_call_that_straddles_the_deadline():
    calls = [(0.0, 4.0, 24), (4.0, 9.0, 24), (9.0, 13.0, 24), (13.5, 15.0, 24)]
    rate, pages, seconds = Y.closed_loop_rate(calls, deadline=10.0)
    assert (pages, seconds) == (72, 13.0)
    assert rate == pytest.approx(72 / 13.0)


@pytest.mark.parametrize("q", [50, 90, 95])
def test_percentile_matches_numpy(q):
    v = np.random.default_rng(3).exponential(2.0, 37)
    assert Y.percentile(v.tolist(), q) == pytest.approx(float(np.percentile(v, q)))


def test_idle_share_of_a_synthetic_trace():
    kernels = [("a", 0.5, 1.0), ("b", 0.8, 1.5), ("a", 3.0, 3.5), ("c", 9.0, 11.0)]
    busy = Y.union_seconds([(s, t) for _, s, t in kernels], 0.0, 10.0)
    assert busy == pytest.approx(2.5)
    assert Y.idle_gaps([(s, t) for _, s, t in kernels], 0.0, 10.0) == \
        [(0.0, 0.5), (1.5, 3.0), (3.5, 9.0)]
    reader = record.load_reader(ROOT / "portbench" / "metrics" / "device_idle_share.py")
    r = SimpleNamespace(trace=SimpleNamespace(window_s=10.0, busy_s=busy))
    assert reader.read(r) == pytest.approx(75.0)


def test_roofline_counts_each_byte_once():
    # 8 pages of 960x960 u8 in, (8, 3, 960, 960) bf16 out, 8 float32 means
    launch = {"in_bytes": [8 * 960 * 960, 8 * 4], "out_bytes": 8 * 3 * 960 * 960 * 2}
    need_s = Y.launch_bytes(launch) / 3.35e12
    assert need_s * 1e3 == pytest.approx(0.0154, abs=1e-4)  # the kernel table's bound ms
    trace = SimpleNamespace(kernels=[("enhance_kernel(EnhanceArgs)", 1.0, 1.0 + 2 * need_s),
                                     ("other", 0.0, 5.0)])
    r = record.Run(window=None, det_calls=[], rec_calls=[], sched=[],
                   probes={"m:f": [launch]}, trace=trace, peaks=Y.peaks("NVIDIA H100 80GB HBM3"),
                   settings={}, weights={})
    assert r.roofline("m:f", "enhance_kernel") == pytest.approx(50.0)
    assert r.roofline("m:missing", "enhance_kernel") is None


def test_crop_bytes_by_hand():
    """Two pages of 960x960 u8, two boxes a page, crops (4, 48, 320) bf16:
    a 100x20 box at width 160 reads its pixels and the next one on each
    axis, 102 x 22 (2 taps a sample cap neither axis); a 900x300 box at
    width 300 reads 2 taps a sample, 600 x 96; a padding box reads nothing;
    a box past the page reads only the page's pixels."""
    aabbs = np.array([[[10, 10, 110, 30], [0, 0, 900, 300]],
                      [[5, 5, 50, 50], [940, 950, 1000, 1000]]], np.float32)
    w_valid = np.array([[160, 300], [0, 40]], np.int32)
    launch = {"pages": ((2, 960, 960), 1), "aabbs": aabbs, "w_valid": w_valid,
              "out": ((4, 48, 320), 2)}
    read = 102 * 22 + 600 * 96 + 0 + (959 - 940 + 1) * (959 - 950 + 1)
    written = 4 * 48 * 320 * 2
    assert Y.crop_launch_bytes(launch) == read + written + 4 * 4 * 4 + 4 * 4
    # the whole stack, as the tensors passed would count it, is far more
    assert Y.crop_launch_bytes(launch) < 2 * 960 * 960 + written


def test_crop_roofline_reads_the_boxes_not_the_stack():
    import torch

    reader = record.load_reader(ROOT / "portbench" / "metrics" / "crop_roofline.py")
    pages = torch.zeros((2, 960, 960), dtype=torch.uint8)
    aabbs = torch.tensor([[[10, 10, 110, 30]], [[5, 5, 50, 50]]], dtype=torch.float32)
    w_valid = torch.tensor([[160], [40]], dtype=torch.int32)
    out = torch.zeros((2, 48, 320), dtype=torch.bfloat16)
    launch = reader.LAUNCH((pages, aabbs, w_valid, (48, 320), torch.bfloat16), {}, out)
    need_s = Y.crop_launch_bytes({**launch, "aabbs": aabbs.numpy(),
                                  "w_valid": w_valid.numpy()}) / 3.35e12
    trace = SimpleNamespace(kernels=[("crop_kernel(CropArgs)", 0.0, 4 * need_s)])
    r = record.Run(window=None, det_calls=[], rec_calls=[], sched=[],
                   probes={reader.PROBE: [launch]}, trace=trace,
                   peaks=Y.peaks("NVIDIA H100 80GB HBM3"), settings={}, weights={})
    assert reader.read(r) == pytest.approx(25.0)
    r.probes[reader.PROBE].append(None)  # a call the metric could not read
    assert reader.read(r) is None


def test_useful_flops_against_closed_forms():
    w = str(ROOT / "ocr_system_tpu_torch" / "weights" / "rec_latin.npz")
    vocab = np.load(w)["head.weight"].shape[0]
    d = 192
    for width in (320, 640):
        t = width // 4
        stem = 2 * 9 * (48 * 3 * 24 * width // 2 + 96 * 48 * 12 * t + 192 * 96 * 6 * t)
        blocks = 6 * (2 * t * 12 * d * d + 4 * t * t * d)
        assert Y.svtr_flops(w, width) == stem + blocks + 2 * t * d * vocab
    det = Y.dbnet_flops(str(ROOT / "ocr_system_tpu_torch" / "weights" / "det.npz"), 960)
    assert det * 8 == pytest.approx(70.76e9, rel=1e-3)  # an 8-page wave on the program


def test_metric_readers_read_spans():
    calls = [{"pages": 8, "ms": {"det": 900.0, "det_neural": 400.0, "det_classical": 480.0,
                                 "route": 20.0}, "turned": 6},
             {"pages": 4, "ms": {"det": 500.0, "det_neural": 200.0, "det_classical": 240.0,
                                 "route": 40.0}, "turned": 0}]
    r = record.Run(window=None, det_calls=calls,
                   rec_calls=[{"pages": 12, "ms": {"rec": 120.0, "rescue": 24.0, "glue": 6.0,
                                                   "finish": 30.0}}],
                   sched=[{"waves": 2, "det_wait": 50.0}, {"waves": 1, "det_wait": 10.0}],
                   probes={}, trace=None, peaks=None, settings={}, weights={})

    def read(name):
        return record.load_reader(ROOT / "portbench" / "metrics" / f"{name}.py").read(r)

    assert read("det_classical_ms_per_page") == pytest.approx(60.0)
    assert read("det_neural_ms_per_page") == pytest.approx(50.0)
    assert read("rec_ms_per_page") == pytest.approx(12.0)
    assert read("finish_ms_per_page") == pytest.approx(3.0)
    assert read("det_wait_ms_per_wave") == pytest.approx(20.0)
    assert read("turned_page_share") == pytest.approx(50.0)
    assert read("enhance_roofline") is None and read("device_idle_share") is None


def _fresh_python(code: str, cwd: Path, env_extra: dict | None = None):
    env = {**os.environ, "PYTHONPATH": str(cwd), **(env_extra or {})}
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_the_harness_loads_nothing_of_the_jax_side():
    code = ("import sys, portbench.run, portbench.judge, portbench.serve, portbench.trace, "
            "portbench.traffic, portbench.record, portbench.tools.calibrate, "
            "ocr_system_tpu_torch.engine.pipeline, ocr_system_tpu_torch.service.orchestrator\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = _fresh_python(code, ROOT)
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & run.FORBIDDEN, loaded & run.FORBIDDEN
    assert "ocr_system_tpu_torch" in loaded  # whole names: the port's name begins with the JAX one's


def test_the_references_import_nothing_of_the_program():
    code = ("import sys, portbench.judge, portbench.yardstick\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = _fresh_python(code, ROOT)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (run.FORBIDDEN | {"ocr_system_tpu_torch"})


def test_no_card_no_result(tmp_path):
    """Without a card the run exits non-zero and prints no result, here
    and in a directory that holds only the benchmark's files."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (ROOT, tmp_path):
        env = {**os.environ, "PYTHONPATH": str(cwd), "CUDA_VISIBLE_DEVICES": ""}
        out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", ALL_CELLS[0],
                              "--seed", "1", "--seconds", "1", "--trace", "0"],
                             cwd=cwd, env=env, capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_cell_is_added_by_new_files_only(tmp_path):
    """A new configuration, mix, per-layer metric and cell: files and
    entries added, no file of the benchmark edited."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "ocr_system_tpu_torch").symlink_to(ROOT / "ocr_system_tpu_torch")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*") if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "portbench" / "configs" / "neural_latin_bf16.json").read_text())
    cfg["settings"]["det_wire_bits"] = 8
    (tmp_path / "portbench" / "configs" / "neural_latin_wire8.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench" / "traffic" / "two_rows.json").write_text(json.dumps(
        {"loop": "closed", "doc_pages": 4, "documents": 2,
         "pages": {"kind": "glyph", "size": 960, "rows": 2, "pool": 4}}))
    (tmp_path / "portbench" / "metrics" / "waves_per_call.py").write_text(
        "def read(run):\n    return sum(s['waves'] for s in run.sched) / len(run.sched)\n")
    bench["configs"].append({"name": "neural_latin_wire8", "source": "x",
                             "file": "portbench/configs/neural_latin_wire8.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "neural_latin_wire8.two_rows.backlog",
                               "config": "neural_latin_wire8", "traffic": "two_rows",
                               "chips": 1, "why": "x"})
    next(m for m in bench["end_to_end"] if m["name"] == "pages_per_s")["workloads"].append(
        "neural_latin_wire8.two_rows.backlog")
    bench["per_layer"].append({"name": "waves_per_call", "unit": "waves", "better": "lower",
                               "source": "program_counter", "layer": "scheduler",
                               "moves": "pages_per_s",
                               "workloads": ["neural_latin_wire8.two_rows.backlog"]})
    (tmp_path / "portbench" / "limits" / "neural_latin_wire8.two_rows.backlog.json").write_text(
        json.dumps({"canvas_px": 0, "det_mad": 0.001, "rec_gap": 1.0}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from portbench import run, traffic, record\n"
            "bench, cell, config, mix, limits = run._cell('neural_latin_wire8.two_rows.backlog')\n"
            "names = [m['name'] for m in run._metrics(bench, cell, True)]\n"
            "r = record.load_reader(run.ROOT / 'portbench' / 'metrics' / 'waves_per_call.py')\n"
            "flow = traffic.generate(mix, 7, 5.0, run.ROOT)\n"
            "print(run.ROOT, names, config['settings']['det_wire_bits'], len(flow.documents[0]),"
            " r.read(type('R', (), {'sched': [{'waves': 2}]})))\n")
    out = _fresh_python(code, tmp_path)
    assert out.returncode == 0, out.stderr
    assert str(tmp_path) in out.stdout and "'waves_per_call'" in out.stdout
    assert out.stdout.strip().endswith("8 4 2.0")
    after = {p: p.read_bytes() for p in before}
    assert after == before
