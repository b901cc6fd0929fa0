"""How far bf16 recognition texts move under bf16 rounding alone.

Runs the JAX package's Latin recognizer in bfloat16 on the committed smoke
forms (``ocr_system_tpu_torch/assets/smoke_forms.npz``), one crop per word
box of the JAX float32 expectations, once with XLA's default CPU options
and once under each option in ``VARIANTS`` (each option changes only
where and in what order bf16 values are rounded), and the port's
recognizer in bfloat16 on the CPU on the same crops. Prints, for each run,
how many texts equal the default JAX bf16 run's and the JAX float32
run's: exactly, and with runs of two or more dots compared regardless of
length (``utils/smoke.same_text``).

    JAX_PLATFORMS=cpu python rec_bf16_probe.py        # ~3 min on 8 cores

Needs JAX and the orbax checkpoint (``checkpoints/rec_latin``), so it runs
where the tests run, not on the GPU machine.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

VARIANTS = {
    "jax, Eigen on one thread": "--xla_cpu_multi_thread_eigen=false",
    "jax, fast math": "--xla_cpu_enable_fast_math=true",
    "jax, no excess precision": "--xla_allow_excess_precision=false",
}


def _inputs():
    from ocr_system_tpu_torch.utils import smoke

    forms, expected = smoke.smoke_forms()
    pages = [np.ascontiguousarray(f) for f in forms]
    quads = [np.array([w["polygon"] for w in p["word"]], np.float32).reshape(-1, 4, 2)
             for p in expected["pages"]["float32"]]
    return pages, quads


def jax_texts(dtype: str) -> list[list[str]]:
    from ocr_system_tpu.core.config import Settings
    from ocr_system_tpu.engine.recognizer import Recognizer

    pages, quads = _inputs()
    rec = Recognizer(Settings(rec_checkpoint="checkpoints/rec_latin", compute_dtype=dtype))
    return [[r.text for r in rr] for rr in rec.recognize_pages(pages, quads)]


def port_texts() -> list[list[str]]:
    from ocr_system_tpu_torch.core.config import Settings
    from ocr_system_tpu_torch.engine.recognizer import Recognizer
    from ocr_system_tpu_torch.utils import smoke

    pages, quads = _inputs()
    rec = Recognizer(Settings(rec_checkpoint=smoke.TRAINED["rec_checkpoint"],
                              compute_dtype="bfloat16"), device="cpu")
    return [[r.text for r in rr] for rr in rec.recognize_pages(pages, quads)]


def _jax_run(flags: str, dtype: str = "bfloat16") -> list[list[str]]:
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
    out = subprocess.run([sys.executable, __file__, "--jax", dtype], env=env, check=True,
                         capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> int:
    if sys.argv[1:2] == ["--jax"]:
        print(json.dumps(jax_texts(sys.argv[2])))
        return 0
    from ocr_system_tpu_torch.utils.smoke import same_text

    ref = _jax_run("")
    f32 = _jax_run("", "float32")
    runs = {"jax, default": ref}
    runs.update({name: _jax_run(flags) for name, flags in VARIANTS.items()})
    runs["port (torch, CPU)"] = port_texts()
    n = sum(len(p) for p in ref)

    def agree(want, got):
        pairs = [(a, b) for pa, pb in zip(want, got) for a, b in zip(pa, pb)]
        others = [(a, b) for a, b in pairs if not same_text(a, b, leaders_any_length=True)]
        return (sum(same_text(a, b) for a, b in pairs),
                sum(same_text(a, b, leaders_any_length=True) for a, b in pairs), others)

    for name, texts in runs.items():
        exact, leaders, others = agree(ref, texts)
        exact32, leaders32, _ = agree(f32, texts)
        print(json.dumps({"run": name, "words": n, "equal": exact,
                          "equal_leaders_any_length": leaders, "other_misses": others,
                          "equal_float32": exact32,
                          "equal_float32_leaders_any_length": leaders32}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
