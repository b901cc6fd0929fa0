"""What holds the crop kernel back: variants of
``ocr_system_tpu_torch/csrc/kernels.cu`` timed beside the committed kernel
on the card.

    python3 crop_variants.py

Each variant is the committed source with a few lines replaced: other block
shapes, or a crop cut down to some of its phases (``taps_only``: the
block's set-up alone; ``zeros_only``: set-up and every output stored as
zero; ``no_page_reads``: everything but the page gathers, which read a
value made from the address instead), so the difference between two rows
is the cost of what one of them skips. All are built at once with the
committed build's ``nvcc`` flags, then each is loaded in the committed
library's place (``_build.SOURCES`` pointed at it) and timed cold and warm
(``chip_smoke.cold_ms`` and ``cuda_ms``) on chip_smoke.py's crop cases, in
both output dtypes;
variants that keep the arithmetic are held equal to the plain version.
Prints one JSON line per variant and pass, then the card's name and power
limit. Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from ocr_system_tpu_torch.kernels import _build, crop

_PAGE = "  const uint8_t* page = pages + (long long)(n / n_per_page) * rows * cols;"
_ROWS = "kCropRows = 16;   // output rows per block"
# name -> (replacements, whether the output still equals the plain version)
VARIANTS = {
    "committed": ({}, True),
    "threads_256": ({"kCropThreads = 128;": "kCropThreads = 256;"}, True),
    "rows_8": ({_ROWS: "kCropRows = 8;   // output rows per block"}, True),
    "rows_48_threads_256": ({_ROWS: "kCropRows = 48;   // output rows per block",
                             "kCropThreads = 128;": "kCropThreads = 256;"}, True),
    "taps_only": ({_PAGE: "  if (wv >= 0) return;\n" + _PAGE}, False),
    "zeros_only": ({"    if (j0 >= wv) {": "    if (j0 >= 0) {"}, False),
    "no_page_reads": ({"0x4B000000u | __ldg(p)":
                       "0x4B000000u | (unsigned)(reinterpret_cast<size_t>(p) & 255)"}, False),
}


def build_all(out_dir: Path) -> dict[str, list[Path]]:
    """Write every variant's source and compile them all at once (one nvcc
    each) to where ``_build`` looks for a build of that source; returns
    each variant's source list."""
    src = _build.SOURCES[0].read_text()
    procs = {}
    for name, (subs, _) in VARIANTS.items():
        text = src
        for old, new in subs.items():
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        cu = out_dir / name / "kernels.cu"
        cu.parent.mkdir(parents=True, exist_ok=True)
        cu.write_text(text)
        _build.SOURCES = [cu]
        so = _build.library_path()
        so.parent.mkdir(parents=True, exist_ok=True)
        procs[name] = ([cu], subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (_, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
    return {name: sources for name, (sources, _) in procs.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("crop_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    committed = _build.SOURCES
    sources = build_all(_build.BUILD_ROOT.parent / "crop_variants")
    flush = torch.empty(cs.FLUSH_BYTES // 4, device=dev)
    rng = np.random.default_rng(cs.SEED + 3)
    pages = torch.from_numpy(rng.integers(0, 256, (8, 960, 960), np.uint8)).to(dev)
    cases = []
    for width in (320, 640, 1280):
        aabbs, wv = (torch.from_numpy(a).to(dev) for a in cs.crop_case(rng, 8, 960, 160, width))
        cases.append((width, aabbs, wv, crop.crop_boxes_plain(pages, aabbs, wv, (48, width))))
    names = list(VARIANTS)
    for rep, order in enumerate((names, names[::-1])):  # both orders, against drift
        for name in order:
            _build.SOURCES, _build._lib = sources[name], None  # loaded on the next launch
            row = {"variant": name, "pass": rep}
            for width, aabbs, wv, ref in cases:
                for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                    def call(dt=dt, aabbs=aabbs, wv=wv, width=width):
                        return crop.crop_boxes(pages, aabbs, wv, (48, width), dt)
                    if VARIANTS[name][1] and not torch.equal(call().float(), ref.to(dt).float()):
                        raise AssertionError(f"variant {name} disagrees at W {width} {tag}")
                    row[f"W{width}_{tag}"] = {"ms": cs.cold_ms(call, flush),
                                              "warm_ms": cs.cuda_ms(call)}
            print(json.dumps(row), flush=True)
    _build.SOURCES, _build._lib = committed, None
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
