"""Find the highest upload rate an open-loop mix sustains, once, on the
card: the uploads served back to back give the service rate; then windows
at fixed fractions of it show whether the backlog grows (how late the last
uploads start) and what the tails are.

    python3 -m portbench.tools.sweep --config portbench/configs/<c>.json \\
        --mix <open-loop mix>.json --seconds 45 --fractions 0.8 1.0 --seed 77

One JSON line per step.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    from ocr_system_tpu_torch.engine.pipeline import document_result

    from portbench import run, serve, traffic, yardstick as Y

    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True, help="a configuration file")
    p.add_argument("--mix", required=True, help="a traffic mix file")
    p.add_argument("--seconds", type=float, default=45.0)
    p.add_argument("--fractions", type=float, nargs="+", default=[0.8, 1.0])
    p.add_argument("--seed", type=int, default=77)
    a = p.parse_args(argv)
    config, mix = (json.loads(Path(f).read_text()) for f in (a.config, a.mix))
    settings, engine, orch = serve.build(config, run.ROOT, True, "cuda")
    rec = serve.Recorder(np.random.default_rng(0), False)
    flow = traffic.generate(mix, a.seed, a.seconds, run.ROOT)
    serve.warm_up(engine, settings, orch, flow, rec)
    t0, n = time.perf_counter(), 0
    while time.perf_counter() - t0 < a.seconds:
        u = flow.uploads[n % len(flow.uploads)]
        outs, _ = serve.run_document(engine, settings, u.pages, rec)
        orch.fields_for(document_result(outs))
        n += 1
    capacity = n / (time.perf_counter() - t0)
    print(json.dumps({"step": "back_to_back", "uploads": n, "uploads_per_s": capacity}),
          flush=True)
    for f in a.fractions:
        rate = f * capacity
        flow = traffic.generate({**mix, "rate_per_s": rate}, a.seed, a.seconds, run.ROOT)
        w = serve.open_loop(engine, settings, orch, flow.uploads, a.seconds, rec)
        starts = [c[0] - w.start - u.due_s for c, u in zip(w.calls, flow.uploads)]
        print(json.dumps({"step": "open", "fraction": f, "rate_per_s": rate,
                          "uploads": len(w.latencies),
                          "p50_s": Y.percentile(w.latencies, 50),
                          "p90_s": Y.percentile(w.latencies, 90),
                          "queue_wait_last_s": starts[-1] if starts else None,
                          "queue_wait_max_s": max(starts, default=None),
                          "drain_s": w.end - w.deadline}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
