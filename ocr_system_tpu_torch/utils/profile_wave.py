"""Where one 8-page wave's time goes on the card.

    python3 -m ocr_system_tpu_torch.utils.profile_wave [--out DIR]

Runs the served engine's ``process_pages`` (every serving default, script
routing included; trained weights, bf16) on the two 8-page waves that
chip_smoke.py drives: the committed Latin forms, and the mixed wave of the
Hindi forms and Latin forms. Each wave runs once to warm up and once under
``utils/profiler.device_trace`` (device: time per CUDA kernel), which also
records the program's spans (host: self time per span name, the time a
span's own code took, its child spans' time left out). Prints one JSON line
per wave with the wall time, the device's busy time and idle share over the
wave, the stage ms, the host self times and the top device kernels; writes
the kernel table and each wave's Chrome trace, the spans merged in, to DIR
(default ``build/profile_wave``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import torch


def device_busy_ms(prof) -> float | None:
    """The device's busy time under a ``torch.profiler`` run: the union of
    its CUDA kernel intervals, in ms (None when it traced none)."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == cuda)
    if not spans:
        return None
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (busy + cur_e - cur_s) / 1e3


def profile(engine, pages, trace_dir: str) -> tuple[dict, str]:
    """One warm-up wave, then one wave under the device trace (written into
    ``trace_dir``): the JSON row and the kernel table."""
    from ocr_system_tpu_torch.utils.profiler import SPANS, device_trace, self_ns

    engine.process_pages(pages)  # warm-up: cuDNN/cuBLAS set-up, kernel build
    torch.cuda.synchronize()

    with device_trace(trace_dir, engine.recognizer.device) as dev_prof:
        t = time.perf_counter_ns()
        engine.process_pages(pages)
        torch.cuda.synchronize()
        t_end = time.perf_counter_ns()
    wall_ms = (t_end - t) / 1e6

    spans = [s for s in SPANS.spans if s.start_ns >= t and s.end_ns <= t_end]
    own = self_ns(spans)
    host: dict[str, float] = defaultdict(float)
    for s in spans:
        host[s.name] += own[s.id] / 1e6
    busy_ms = device_busy_ms(dev_prof)
    averages = dev_prof.key_averages()
    table = averages.table(sort_by="self_device_time_total", row_limit=30)
    device_top = sorted(
        ((a.key, a.self_device_time_total / 1e3) for a in averages
         if a.self_device_time_total > 0),
        key=lambda kv: -kv[1],
    )[:12]
    return {
        "device": torch.cuda.get_device_name(0),
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
        "host_self_ms": dict(sorted(host.items(), key=lambda kv: -kv[1])),
        "spans": len(spans),
        "device_top_ms": device_top,
        "stage_ms": dict(engine.stage_ms),
        "rescued": engine.rescued,
    }, table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/profile_wave")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_wave: no CUDA device", file=sys.stderr)
        return 1
    from ocr_system_tpu_torch.engine.preprocess import PageImage
    from ocr_system_tpu_torch.utils.smoke import build_engine, hindi_forms, smoke_forms

    engine = build_engine("cuda")
    forms, expected = smoke_forms()
    waves = {"latin": list(forms),
             "mixed": [*hindi_forms(), *forms[:expected["mixed_latin"]]]}
    os.makedirs(args.out, exist_ok=True)
    for name, arrays in waves.items():
        row, table = profile(engine, [PageImage(p, i + 1) for i, p in enumerate(arrays)],
                             args.out)
        with open(os.path.join(args.out, f"profile_wave_{name}.txt"), "w") as f:
            f.write(table)
        print(json.dumps({"wave": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
