"""Where one 8-page wave's time goes on the card.

    python3 -m ocr_system_tpu_torch.utils.profile_wave [--out DIR]

Runs the served engine's ``process_pages`` (every serving default, script
routing included; trained weights, bf16) on the two 8-page waves that
chip_smoke.py drives: the committed Latin forms, and the mixed wave of the
Hindi forms and Latin forms. Each wave runs once to warm up and once under
both ``cProfile`` (host: cumulative time per function) and
``torch.profiler`` (device: time per CUDA kernel). Prints one JSON line
per wave with the wall time, the device's busy time and idle share over
the wave, the stage ms, and the top host functions and device kernels;
writes the full tables to DIR (default ``build/profile_wave``). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import sys
import time

import torch

# host functions worth naming in the breakdown (module path fragment,
# function name)
_HOST = (
    ("engine/detector.py", "detect_batch"),
    ("engine/detector.py", "_letterbox_host"),
    ("engine/detector.py", "_rotate_host"),
    ("engine/detector.py", "_forward"),
    ("device_boxes.py", "propagate_labels"),
    ("device_boxes.py", "component_stats"),
    ("boxes.py", "boxes_from_stats"),
    ("boxes.py", "boxes_from_prob_map"),
    ("engine/detector.py", "_ink_and_emit"),
    ("engine/detector.py", "_ink_snap"),
    ("image_ops.py", "estimate_skew_angle"),
    ("dbnet.py", "forward_nchw"),
    ("recognizer.py", "_rec_on_stack"),
    ("classical_detector.py", "_detect_one"),
    ("hybrid_detector.py", "detect_batch"),
    ("host_image.py", "adaptive_threshold"),
    ("cc_label.py", "label"),
    ("cc_label.py", "label_cv2"),
    ("selection_marks.py", "page_components"),
    ("selection_marks.py", "detect_selection_marks"),
    ("handwriting.py", "detect_handwriting"),
    ("pipeline.py", "_route_and_normalize"),
    ("script.py", "page_script"),
    ("script.py", "resegment_devanagari"),
    ("script.py", "crop_script"),
    ("pipeline.py", "_confidence_rescue"),
    ("pipeline.py", "_digit_glyph_rescue"),
    ("pipeline.py", "_split_glued"),
    ("pipeline.py", "_finish_page"),
)


def _host_rows(prof: cProfile.Profile) -> dict[str, float]:
    stats = pstats.Stats(prof)
    out = {}
    for (path, _, name), (_, _, _, cum, _) in stats.stats.items():
        for frag, fn in _HOST:
            if name == fn and path.endswith(frag):
                out[f"{frag}:{fn}"] = out.get(f"{frag}:{fn}", 0.0) + cum * 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def profile(engine, pages) -> tuple[dict, str]:
    """One warm-up wave, then one wave under both profilers: the JSON row
    and the full tables."""
    engine.process_pages(pages)  # warm-up: cuDNN/cuBLAS set-up, kernel build
    torch.cuda.synchronize()

    host = cProfile.Profile()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as dev_prof:
        t = time.perf_counter()
        host.enable()
        engine.process_pages(pages)
        torch.cuda.synchronize()
        host.disable()
        wall_ms = (time.perf_counter() - t) * 1e3

    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in dev_prof.events() if e.device_type == cuda]
    busy_ms = None
    if events:
        # union of kernel intervals: the device's busy time over the wave
        spans = sorted((e.time_range.start, e.time_range.end) for e in events)
        busy, cur_s, cur_e = 0.0, *spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy_ms = (busy + cur_e - cur_s) / 1e3
    averages = dev_prof.key_averages()
    table = averages.table(sort_by="self_device_time_total", row_limit=30)
    device_top = sorted(
        ((a.key, a.self_device_time_total / 1e3) for a in averages
         if a.self_device_time_total > 0),
        key=lambda kv: -kv[1],
    )[:12]
    buf = io.StringIO()
    pstats.Stats(host, stream=buf).sort_stats("cumulative").print_stats(40)
    return {
        "device": torch.cuda.get_device_name(0),
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
        "host_cumulative_ms": _host_rows(host),
        "device_top_ms": device_top,
        "stage_ms": dict(engine.stage_ms),
        "rescued": engine.rescued,
    }, table + "\n\n" + buf.getvalue()


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
        row, tables = profile(engine, [PageImage(p, i + 1) for i, p in enumerate(arrays)])
        with open(os.path.join(args.out, f"profile_wave_{name}.txt"), "w") as f:
            f.write(tables)
        print(json.dumps({"wave": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
