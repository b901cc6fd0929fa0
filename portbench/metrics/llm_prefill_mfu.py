"""Extraction, prefill, against the card's peak: the useful FLOPs of the
window's prefills (``dsv2_yardstick.prefill_flops`` of each ``llm.prefill``
span's ``tokens``, from the configuration's widths: the active parameters,
causal attention, the head at the last position) over the spans' time on
the host's clock, as a share of the dense bf16 peak."""

from portbench import dsv2_yardstick as Y
from portbench import spans as S


def read(run):
    prefill = [s for s in S.in_window(run) or [] if s.name == "llm.prefill"]
    d = Y.config_of(run)
    took = sum(s.end_ns - s.start_ns for s in prefill)
    if not took or d is None or run.peaks is None:
        return None
    flops = sum(Y.prefill_flops(d, s.counts.get("tokens", 0)) for s in prefill)
    return 100.0 * flops / (took / 1e9) / run.peaks["bf16_flops"]
