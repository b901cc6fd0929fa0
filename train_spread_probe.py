"""How far the JAX package's own training steps move under changes that move
only rounding: the bar for the port's float32 training phases.

Runs the JAX record of ``export_torch_weights.jax_train_record`` (3 steps of
each trainer from the trained weights on the committed batches,
``ocr_system_tpu_torch/assets/train_batches.npz``) at float32 once as it
is and once under each change in ``VARIANTS``: an XLA CPU option that
changes only how sums are split and rounded (fast math's reassociation,
the vector width, threads), the batch's samples put in another order
(every batch mean, BatchNorm statistic and gradient sum is then added up
in another order), or the start weights rounded to float32 the other way
(each moved one ulp up or down at random). For each recorded number (the loss of
each step, the first step's gradient norm, each parameter group's norm and
the first and last BatchNorm's running statistics after step 3) it writes
the JAX package's own spread to
``ocr_system_tpu_torch/assets/train_spread.json``: the range of the
number over all these runs (largest minus smallest; for a vector, the
largest such range of an element) relative to the unchanged run's value
(for a vector, its largest magnitude). chip_smoke.py's
``train_*_float32`` phases hold the port's deviation from the JAX record
(the unchanged run) to ``TRAIN_BAR_FACTOR`` times it: another
implementation that rounds otherwise is one more such run, drawn from a
wider distribution. The file also keeps every run's numbers, each
variant's deviation from the unchanged run, and the unchanged run's from
the committed record.

    JAX_PLATFORMS=cpu python train_spread_probe.py      # ~35 min on 8 cores

With ``--bf16`` it instead writes, under ``bfloat16_strict`` in the same
file, the JAX record at bf16 compute once more with XLA's excess precision
off (``BF16_STRICT``): the reference's bf16 numbers with every operation's
result rounded to bf16, as PyTorch rounds each operation's result
(~8 min).

    JAX_PLATFORMS=cpu python train_spread_probe.py --bf16

Needs JAX and the orbax checkpoints, so it runs where the tests run, not on
the GPU machine.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

# name -> (XLA_FLAGS, how the batch's samples are reordered or the seed of
# the start weights' one-ulp moves). Fast math
# lets XLA reassociate reductions (and use its approximate elementary
# functions, within a few ulps); capping the instruction set narrows XLA's
# vectors (and drops the fused multiply-add), which reorders and rerounds
# the sums inside every dot and convolution; Eigen on one thread splits the
# recognizer's reductions otherwise; moving every start weight and
# statistic one float32 ulp up or down at random is the same weights rounded
# the other way, a rounding difference at every input of every product
VARIANTS = {
    "fast math": ("--xla_cpu_enable_fast_math=true", None),
    "max ISA SSE4.2": ("--xla_cpu_max_isa=SSE4_2", None),
    "max ISA AVX": ("--xla_cpu_max_isa=AVX", None),
    "eigen on one thread": ("--xla_cpu_multi_thread_eigen=false", None),
    "batch reversed": ("", "reverse"),
    "batch rolled by half": ("", "roll"),
    "weights one ulp off, seed 1": ("", "ulp1"),
    "weights one ulp off, seed 2": ("", "ulp2"),
}


# XLA's CPU compiler keeps bf16 intermediates of a fusion in float32 unless
# this is off, so the default bf16 record rounds to bf16 only where a fusion
# ends, not after each operation
BF16_STRICT = "--xla_allow_excess_precision=false"


def _reordered(batches: dict, how: str | None) -> dict:
    if how and how.startswith("ulp"):
        return batches

    def f(a):
        if how == "reverse":
            return np.ascontiguousarray(a[::-1])
        if how == "roll":
            return np.roll(a, len(a) // 2, axis=0)
        return a

    return {name: {k: f(v) for k, v in b.items()} for name, b in batches.items()}


def _record(how: str | None, dtype: str) -> dict:
    from export_torch_weights import jax_train_record
    from ocr_system_tpu_torch.utils import smoke

    ulp_seed = int(how[3:]) if how and how.startswith("ulp") else None
    return jax_train_record(_reordered(smoke.train_batches(), how), dtypes=(dtype,),
                            ulp_seed=ulp_seed)


def _run(flags: str, how: str | None, dtype: str = "float32") -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
    out = subprocess.run([sys.executable, __file__, "--jax", how or "", dtype], env=env,
                         check=True, capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])[dtype]


def spread(runs: list[dict], base: dict) -> dict:
    """The range of each recorded number over ``runs`` (one trainer's rows
    each) relative to ``base``'s value, as ``train_deviation`` lays out a
    deviation."""
    def rng(values, ref):
        v = np.asarray(values, np.float64)
        return float((v.max(0) - v.min(0)).max() / max(np.abs(np.asarray(ref)).max(), 1e-30))

    out = {"loss": [rng([r["loss"][i] for r in runs], base["loss"][i])
                    for i in range(len(base["loss"]))],
           "grad_norm": rng([r["grad_norm"][0] for r in runs], base["grad_norm"][0]),
           "group_norms": {g: rng([r["group_norms"][g] for r in runs], v)
                           for g, v in base["group_norms"].items()}}
    if "tag_acc" in base:
        out["tag_acc"] = [float(np.ptp([r["tag_acc"][i] for r in runs]))
                          for i in range(len(base["tag_acc"]))]
    if "bn" in base:
        out["bn"] = {m: {k: rng([r["bn"][m][k] for r in runs], v) for k, v in stats.items()}
                     for m, stats in base["bn"].items()}
    return out


def main() -> int:
    if sys.argv[1:2] == ["--jax"]:
        print(json.dumps(_record(sys.argv[2] or None, sys.argv[3])))
        return 0
    from ocr_system_tpu_torch.utils import smoke
    from ocr_system_tpu_torch.utils.smoke import train_deviation

    if sys.argv[1:2] == ["--bf16"]:
        out = smoke.train_spread()
        out["bfloat16_strict"] = _run(BF16_STRICT, None, "bfloat16")
        smoke.TRAIN_SPREAD.write_text(json.dumps(out, indent=1) + "\n")
        print(json.dumps({n: r["loss"] for n, r in out["bfloat16_strict"].items()}))
        return 0

    base = _run("", None)
    record = smoke.train_expected()["float32"]
    out: dict = {"variants": {}, "record_vs_unchanged": {
        name: train_deviation(base[name], record[name]) for name in base}}
    runs = [base]
    for label, (flags, how) in VARIANTS.items():
        run = _run(flags, how)
        runs.append(run)
        dev = {name: train_deviation(run[name], base[name]) for name in base}
        out["variants"][label] = dev
        out.setdefault("runs", {"unchanged": base})[label] = run
        print(label, json.dumps({n: d["loss"] for n, d in dev.items()}), flush=True)
    out["float32"] = {name: spread([r[name] for r in runs], base[name]) for name in base}
    smoke.TRAIN_SPREAD.write_text(json.dumps(out, indent=1) + "\n")
    print(json.dumps(out["float32"], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
