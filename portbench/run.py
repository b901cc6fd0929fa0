"""Run one benchmark cell once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic mix
and its metrics are found by name in ``BENCHMARK.json``: a configuration
in ``portbench/configs/<name>.json``, a mix in
``portbench/traffic/<name>.json``, a per-layer metric's reader in
``portbench/metrics/<name>.py``, the cell's limits of its comparisons in
``portbench/limits/<cell>.json``, and a comparison that is not one of
``judge.py``'s own in ``portbench/checks/<name>.py``.

Set-up (process start to the first timed call): imports, CUDA, the engine
from ``get_engine`` with its weights and kernel builds (cached under
``build/``), the traffic from the seed, and one pass over the shapes the
cell's traffic uses. Then the window, then the check of what it produced
against the references (not counted anywhere), then the result: host facts
on the line before the last, the comparisons as the last lines of standard
error, and one JSON object as the last line of standard output.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ocr_system_tpu"}


def _since_process_start() -> float:
    """Seconds since this process started (its start time in clock ticks
    after boot, against the boot-time clock)."""
    fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start


def _cell(name: str) -> tuple[dict, dict, dict, dict, dict]:
    """The benchmark, the cell, its configuration file, its mix and the
    limits of its comparisons."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"unknown workload {name!r}")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((ROOT / "portbench" / "limits" / f"{name}.json").read_text())
    return bench, cell, config, mix, limits


def _metrics(bench: dict, cell: dict, trace: bool) -> list[dict]:
    """The metrics this cell reports: its end-to-end ones, or with a trace
    its per-layer ones (those that name it, or that name no cells and
    move an end-to-end metric it reports)."""
    def applies(m):
        return cell["name"] in m["workloads"] if "workloads" in m else True

    e2e = [m for m in bench["end_to_end"] if applies(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell["name"] in m.get("workloads", [cell["name"]]) and m["moves"] in names]


def _host_facts(device: str) -> dict:
    import torch

    facts = {"torch": torch.__version__, "cuda": torch.version.cuda,
             "host_cores": os.cpu_count(), "cores_usable": len(os.sched_getaffinity(0))}
    if device == "cuda":
        q = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
        try:
            out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                                 capture_output=True, text=True, timeout=20)
            facts["nvidia_smi"] = out.stdout.strip().splitlines()
        except (OSError, subprocess.TimeoutExpired) as e:
            facts["nvidia_smi"] = f"not read: {e}"
    return facts


def _builds() -> dict:
    """Which of the program's build caches in this checkout hold a library."""
    return {"cuda_kernels": any((ROOT / "build" / "torch_kernels").glob("*/libocr_kernels.so")),
            "native_ops": any((ROOT / "build" / "torch_native").glob("*/libocrnative.so"))}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str | None = None) -> tuple[int, dict | None]:
    """One run of a cell: (exit code, result). ``device`` None is the card,
    as the benchmark runs; tests pass "cpu" to drive a run without one."""
    import numpy as np
    import torch

    t_setup0 = _since_process_start()
    t_origin = time.perf_counter() - t_setup0  # this process's start, on perf_counter
    bench, cell, config, mix, limits = _cell(workload)
    chips = cell["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
                  file=sys.stderr)
            return 2, None
        device = "cuda"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    try:
        import ocr_system_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not in this checkout: {e}", file=sys.stderr)
        return 3, None

    from portbench import judge, serve, trace as tr, traffic, yardstick as Y
    from portbench.record import Run, load_reader

    metrics = _metrics(bench, cell, trace)
    readers = {m["name"]: load_reader(ROOT / "portbench" / "metrics" / f"{m['name']}.py")
               for m in metrics if trace}
    probes = {r.PROBE: getattr(r, "LAUNCH", None) for r in readers.values()
              if getattr(r, "PROBE", None)}
    check_files = judge.check_files(limits)
    builds_before = _builds()
    settings, engine, orch = serve.build(config, ROOT, mix.get("extract", False), device)
    flow = traffic.generate(mix, seed, seconds, ROOT)
    rec = serve.Recorder(np.random.default_rng([seed, 2]), trace, keep_seed=seed)
    rec.install(engine, orch.extractor if orch else None, probes, check_files)
    serve.warm_up(engine, settings, orch, flow, rec)
    rec.reset()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_origin

    prof = tr.profiler() if trace else None
    if prof is not None:
        prof.__enter__()
    clock_offset = time.time() - time.perf_counter()
    with torch.profiler.record_function(tr.WINDOW):
        if flow.loop == "closed":
            w = serve.closed_loop(engine, settings, flow.documents, seconds, rec, orch=orch)
        else:
            w = serve.open_loop(engine, settings, orch, flow.uploads, seconds, rec)
        if device == "cuda":
            torch.cuda.synchronize()
    device_trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        device_trace = tr.read(prof, rec.spans, clock_offset)
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"

    # ---- end to end ----
    values: dict[str, float] = {"setup_s": setup_s}
    if flow.loop == "closed":
        rate, pages, window_s = Y.closed_loop_rate(w.calls, w.deadline)
        values["pages_per_s"] = rate
        attempted = pages
        failed = sum(s.failed for s in w.served) + w.failed_extracts
    else:
        window_s = w.end - w.start
        values["upload_latency_p50_s"] = Y.percentile(w.latencies, 50)
        values["upload_latency_p90_s"] = Y.percentile(w.latencies, 90)
        attempted = len(flow.uploads)
        failed = w.failed_uploads + sum(1 for s in w.served if s.failed)
    weights = {k: str(ROOT / v["path"]) for k, v in config["weights"].items()}
    run = Run(w, rec.det_calls, rec.rec_calls, w.sched, rec.probes, device_trace,
              Y.peaks(kind), config["settings"], weights, window_s)
    out_metrics = {}
    for m in metrics:
        v = values.get(m["name"]) if not trace else readers[m["name"]].read(run)
        if v is not None and math.isfinite(v):
            out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # ---- the check, after the window, with the program's state let go ----
    rec.restore()
    det_samples, layout_windows = rec.det_samples, rec.layout_windows
    judged = (rec.judge_pool, rec.longest)
    captures = rec.captures
    del engine, orch, rec
    if device == "cuda":
        torch.cuda.empty_cache()
    checks, n_words = judge.check_all(config, weights, settings, det_samples, judged,
                                      layout_windows, flow.extract, seed, device)
    checks.update(judge.read_checks(
        check_files, captures, judge.CheckContext(config, weights, settings, seed, device)))
    # the cell compares the numbers its limits file names, each of which
    # the run has to read
    correct = failed == 0
    for name, limit in limits.items():
        value = checks.get(name)
        correct &= value is not None and value <= limit

    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        print(f"portbench: modules of the JAX side were loaded: {loaded}", file=sys.stderr)
        return 4, None

    facts = _host_facts(device)
    facts.update({"builds_cached_before": builds_before, "window_s": window_s,
                  "calls": len(w.calls), "words_checked": n_words,
                  "det_waves_checked": len(det_samples)})
    if flow.loop == "open":
        facts.update({"uploads_due": len(flow.uploads), "uploads_served": len(w.latencies),
                      "generator_late_s_max": max(w.lateness, default=0.0),
                      "generator_late_s_mean": (sum(w.lateness) / len(w.lateness)
                                                if w.lateness else 0.0),
                      "latencies_s": [round(x, 3) for x in w.latencies]})
    print("portbench host " + json.dumps(facts))
    shown = {k: {"value": checks.get(k), "limit": v} for k, v in limits.items()}
    for k, v in shown.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    dev = {"platform": "gpu" if device == "cuda" else device, "kind": kind, "count": chips,
           "memory_peak_bytes": memory_peak}
    if device_trace is not None:
        dev.update({"busy_s": device_trace.busy_s, "window_s": device_trace.window_s})
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": out_metrics, "device": dev}
    if device_trace is not None:
        result["breakdown"] = {"device_ops": device_trace.device_ops,
                               "idle_gaps": device_trace.idle_gaps}
    result["checks"] = shown
    return 0, result


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    code, result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    sys.stderr.flush()
    if result is not None:
        print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
