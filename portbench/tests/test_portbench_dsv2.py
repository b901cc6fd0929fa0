"""The DeepSeek-V2 extraction cell's comparison on the CPU, in a copy of
the benchmark with a tiny variant of its configuration and mix
(``deepseek_v2_tiny``, 2-page form documents, 48 generated ids) added as
new files and entries: ``run_cell`` reads ``dsv2_logit_gap`` and
``correct`` follows its limit, each of the file's ``FAULTS`` makes the run
incorrect, and ``tools/calibrate.py`` reads the control. The per-layer
readers of the extraction layer, on a span log made here.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import dsv2_yardstick as Y
from portbench.record import load_reader

ROOT = Path(__file__).resolve().parents[2]
CHECK = "dsv2_logit_gap"
CONFIG = "hybrid_deepseek_v2_lite_bf16"
CELL = "hybrid_deepseek_v2_tiny_bf16.forms2_extract.backlog"
TINY = {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 96,
        "moe_intermediate_size": 32, "num_hidden_layers": 3, "num_attention_heads": 4,
        "n_routed_experts": 8, "n_shared_experts": 1, "num_experts_per_tok": 2,
        "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16}
LLM_METRICS = ("llm_decode_ms_per_token", "llm_prefill_ms_per_page", "llm_decode_roofline",
               "llm_prefill_mfu")
# the tiny variant's own limit of the comparison: its program read
# 0.0002-0.0006 over three seeds, topk_renormalized 0.039-0.049
TINY_LIMIT = 0.01


def tiny_checkout(dest: Path) -> None:
    """A copy of the benchmark in ``dest`` (the program linked in) with the
    tiny variant's configuration, mix, limits and cell added."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(ROOT / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "ocr_system_tpu_torch").symlink_to(ROOT / "ocr_system_tpu_torch")
    pb = dest / "portbench"
    config = json.loads((pb / "configs" / f"{CONFIG}.json").read_text())
    config.update(TINY)
    config["settings"].update({"llm_model": "deepseek_v2_tiny", "llm_max_new_tokens": 48,
                               "det_batch_size": 2})
    (pb / "configs" / "hybrid_deepseek_v2_tiny_bf16.json").write_text(json.dumps(config))
    mix = json.loads((pb / "traffic" / "forms8_extract.json").read_text())
    mix.update({"doc_pages": 2, "documents": 2, "pages": {**mix["pages"], "copies": 1}})
    (pb / "traffic" / "forms2_extract.json").write_text(json.dumps(mix))
    limits = json.loads((pb / "limits" / f"{CONFIG}.forms8_extract.backlog.json").read_text())
    (pb / "limits" / f"{CELL}.json").write_text(json.dumps({**limits, CHECK: TINY_LIMIT}))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "hybrid_deepseek_v2_tiny_bf16", "source": "test",
                             "file": "portbench/configs/hybrid_deepseek_v2_tiny_bf16.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "hybrid_deepseek_v2_tiny_bf16",
                               "traffic": "forms2_extract", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CONFIG + ".forms8_extract.backlog" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def _python(args: list[str], cwd: Path) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(cwd), "CUDA_VISIBLE_DEVICES": ""}
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=900)


RUNS = f"""
import json, sys
from portbench import judge, run
faults = judge.check_faults()
fault = sys.argv[1]
if fault != "none":
    faults[fault](setattr)
code, r = run.run_cell("{CELL}", 2**31 + 11, 0.1, True, device="cpu")
assert code == 0
print(json.dumps(r))
"""


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    dest = tmp_path_factory.mktemp("dsv2")
    tiny_checkout(dest)
    return dest


def _run(checkout: Path, fault: str) -> dict:
    out = _python(["-c", RUNS, fault], checkout)
    assert out.returncode == 0, out.stderr[-4000:]
    assert f"check {CHECK} " in out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_comparison_decides_correct(checkout):
    r = _run(checkout, "none")
    assert r["correct"], r["checks"]
    assert 0 <= r["checks"][CHECK]["value"] <= TINY_LIMIT
    assert r["attempted"] >= 2 and r["failed"] == 0
    # the traced run reads the extraction layer's spans (the CPU has no
    # device trace and no known peaks: no decode time, roofline or MFU)
    assert r["metrics"]["llm_prefill_ms_per_page"]["value"] > 0, r["metrics"]
    for name in ("llm_decode_ms_per_token", "llm_decode_roofline", "llm_prefill_mfu"):
        assert name not in r["metrics"], r["metrics"]
    limit = (checkout / "portbench" / "limits" / f"{CELL}.json")
    limits = json.loads(limit.read_text())
    limit.write_text(json.dumps({**limits, CHECK: r["checks"][CHECK]["value"] - 1e-3}))
    try:
        tight = _run(checkout, "none")
    finally:
        limit.write_text(json.dumps(limits))
    assert not tight["correct"]


@pytest.mark.parametrize("fault", ["shared_expert_dropped", "topk_renormalized", "rope_dropped"])
def test_each_fault_makes_the_run_incorrect(checkout, fault):
    r = _run(checkout, fault)
    assert not r["correct"] and r["checks"][CHECK]["value"] > TINY_LIMIT, r["checks"]


def test_calibrate_reads_the_control(checkout):
    out = _python(["-m", "portbench.tools.calibrate", "--config",
                   "portbench/configs/hybrid_deepseek_v2_tiny_bf16.json", "--mix",
                   "portbench/traffic/forms2_extract.json", "--seeds", "1", "--control-seeds",
                   "1", "--seconds", "0.1", "--first-seed", "5", "--device", "cpu",
                   "--check", CHECK], checkout)
    assert out.returncode == 0, out.stderr[-4000:]
    sides = {r["side"]: r["checks"] for r in map(json.loads, out.stdout.strip().splitlines())}
    assert sides["program"][CHECK] <= TINY_LIMIT < sides["control"][CHECK], sides
    out = _python(["-m", "portbench.tools.calibrate", "--help"], checkout)
    assert all(f in out.stdout for f in ("shared_expert_dropped", "topk_renormalized"))


# ---- the extraction layer's readers ----

def _span(i, name, start_ms, end_ms, parent=-1, **counts):
    return SimpleNamespace(id=i, name=name, parent=parent, start_ns=int(start_ms * 1e6),
                           end_ns=int(end_ms * 1e6), counts=counts)


@pytest.fixture
def log(monkeypatch):
    """A window of one 8-page document: det_stage, then a generate of a
    2000-token prompt and 3 decode steps in one decode span of 40 ms, in
    which the device trace has 24 ms of device work (overlapping
    operations counted once; those outside the span cut off)."""
    from ocr_system_tpu_torch.utils import profiler

    spans = [_span(0, "det_stage", 0, 100, pages=8), _span(1, "llm.generate", 100, 300),
             _span(2, "llm.prefill", 110, 150, parent=1, tokens=2000),
             _span(3, "llm.decode", 150, 190, parent=1, tokens=3)]
    monkeypatch.setattr(profiler.SPANS, "spans", spans)
    monkeypatch.setattr(Y, "clock_offset", lambda: 1000.0)  # the trace's clock, 1000 s on
    ms = [(140, 155), (152, 160), (170, 178), (185, 200), (300, 310)]
    kernels = [("k", 1000 + a / 1e3, 1000 + b / 1e3) for a, b in ms]
    settings = json.loads((ROOT / "portbench" / "configs" / f"{CONFIG}.json").read_text())[
        "settings"]
    return SimpleNamespace(window=SimpleNamespace(start=0.0, end=1.0), settings=settings,
                           peaks={"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
                           trace=SimpleNamespace(kernels=kernels))


def test_the_extraction_readers(log):
    read = {m: load_reader(ROOT / "portbench" / "metrics" / f"{m}.py").read for m in LLM_METRICS}
    d = json.loads((ROOT / "portbench" / "configs" / f"{CONFIG}.json").read_text())
    assert Y.config_of(log)["num_hidden_layers"] == 27
    assert read["llm_decode_ms_per_token"](log) == pytest.approx((10 + 8 + 5) / 3)
    assert read["llm_prefill_ms_per_page"](log) == pytest.approx(40.0 / 8)
    need = sum(Y.decode_step_bytes(d, 2000 + j, "bfloat16") for j in range(3))
    assert read["llm_decode_roofline"](log) == pytest.approx(100 * need / 3.35e12 / 0.023)
    no_trace = SimpleNamespace(**{**vars(log), "trace": None})
    assert read["llm_decode_ms_per_token"](no_trace) is None
    assert read["llm_decode_roofline"](no_trace) is None
    assert read["llm_prefill_mfu"](log) == pytest.approx(
        100 * Y.prefill_flops(d, 2000) / 0.040 / 989e12)
    log.settings = {**log.settings, "llm_model": "other"}  # no configuration of its own
    assert read["llm_decode_roofline"](log) is None and read["llm_prefill_mfu"](log) is None


def test_the_yardstick_from_the_published_widths():
    """2.451 B parameters a decode step at batch 1 (27 attention blocks of
    13.77 M with their norms, the dense MLP, per MoE layer the router, the
    shared pair and 6 experts, the head and an embedding row); 576 latent
    values a token and layer."""
    d = json.loads((ROOT / "portbench" / "configs" / f"{CONFIG}.json").read_text())
    assert Y.decode_params(d) == 2_451_437_056
    assert (Y.decode_step_bytes(d, 100, "bfloat16") - Y.decode_step_bytes(d, 99, "bfloat16")
            == 27 * 576 * 2)
    s = 1000
    per_token = (Y.prefill_flops(d, s) - 27 * s * s / 2 * 16 * 2 * 320 - 2 * 102400 * 2048) / s
    assert per_token / 2 == 27 * 13_762_560 + 3 * 2048 * 10944 + 26 * (64 * 2048
                                                                       + 8 * 3 * 2048 * 1408)


def test_an_empty_window_reads_nothing(monkeypatch):
    from ocr_system_tpu_torch.utils import profiler

    monkeypatch.setattr(profiler.SPANS, "spans", [])
    run = SimpleNamespace(window=SimpleNamespace(start=0.0, end=1.0), settings={}, peaks=None,
                          trace=None)
    for m in LLM_METRICS:
        assert load_reader(ROOT / "portbench" / "metrics" / f"{m}.py").read(run) is None
