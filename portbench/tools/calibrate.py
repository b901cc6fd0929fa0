"""The readings a cell's limits are set from: the program's comparisons on
many seeds and the control's (the references a precision below bfloat16
in the program's place) on a few, in one process on the card, at the cell's own sizes;
with ``--fault``, the program with that fault of ``faults.py`` (or of a
comparison file's ``FAULTS``) planted; with ``--check <name>``, the
comparison file ``checks/<name>.py`` read on both sides too.

    python3 -m portbench.tools.calibrate --config portbench/configs/<c>.json \\
        --mix portbench/traffic/<m>.json --seeds 12 --control-seeds 3 \\
        --seconds 1 --first-seed 1000 [--fault boxes_dropped] [--check <name>] \\
        > readings.jsonl

Each seed runs the cell's traffic for a short window (every call that
begins in it runs to its end: at least one whole document, or the uploads
due in it) through the same engine, then the same check as a run. One JSON
line per seed and side, with every word's gap.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    from portbench import faults, judge, run, serve, traffic
    from portbench.reference import models as M

    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, help="a configuration file")
    p.add_argument("--mix", required=True, help="a traffic mix file")
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--first-seed", type=int, default=1000)
    p.add_argument("--device", default="cuda")
    all_faults = {**judge.check_faults(), **faults.FAULTS}
    p.add_argument("--fault", choices=sorted(all_faults), default=None)
    p.add_argument("--check", action="append", default=[],
                   help="a comparison file's name (checks/<name>.py); repeatable")
    a = p.parse_args(argv)
    if a.fault:
        all_faults[a.fault](setattr)
    config, mix = (json.loads(Path(f).read_text()) for f in (a.config, a.mix))
    root = run.ROOT
    check_files = judge.check_files(a.check)
    settings, engine, orch = serve.build(config, root, mix.get("extract", False), a.device)
    weights = {k: str(root / v["path"]) for k, v in config["weights"].items()}
    rec = serve.Recorder(np.random.default_rng(0), False)
    rec.install(engine, orch.extractor if orch else None, checks=check_files)
    for k in range(a.seeds):
        seed = a.first_seed + k * 7919
        flow = traffic.generate(mix, seed, a.seconds, root)
        if k == 0:
            serve.warm_up(engine, settings, orch, flow, rec)
        rec.reset(np.random.default_rng([seed, 2]), keep_seed=seed)
        t = time.perf_counter()
        if flow.loop == "closed":
            w = serve.closed_loop(engine, settings, flow.documents, a.seconds, rec, orch=orch)
        else:
            w = serve.open_loop(engine, settings, orch, flow.uploads, a.seconds, rec)
        program = a.fault or "program"
        sides = [(program, None)] + ([("control", M.FP8)] if k < a.control_seeds else [])
        for side, control in sides:
            gaps: list = []
            checks, n = judge.check_all(config, weights, settings, rec.det_samples,
                                        (rec.judge_pool, rec.longest), rec.layout_windows,
                                        flow.extract, seed, a.device, control, gaps)
            checks.update(judge.read_checks(
                check_files, rec.captures,
                judge.CheckContext(config, weights, settings, seed, a.device), control))
            g = np.array(gaps)
            print(json.dumps({"seed": seed, "side": side, "checks": checks, "words": n,
                              "gap_mean": float(g.mean()) if len(g) else None,
                              "gap_share_pos": float((g > 1e-6).mean()) if len(g) else None,
                              "gap_p99": float(np.percentile(g, 99)) if len(g) else None,
                              "window_s": time.perf_counter() - t,
                              "failed": (sum(s.failed for s in w.served) + w.failed_uploads
                                         + w.failed_extracts)}),
                  flush=True)
    rec.restore()
    return 0


if __name__ == "__main__":
    sys.exit(main())
