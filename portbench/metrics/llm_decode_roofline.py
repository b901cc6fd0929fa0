"""Extraction, decode, against the card's memory bandwidth: the least
bytes of the window's decode steps (``dsv2_yardstick.decode_step_bytes``,
from the configuration's widths: the parameters a step at batch 1 reads,
once, and the latent cache read over its positions, one written; step j
of a document after its ``llm.prefill`` ``tokens`` and j before it) at the
published HBM bandwidth, over the card's busy time inside the
``llm.decode`` spans (``dsv2_yardstick.decode_device``)."""

from portbench import dsv2_yardstick as Y
from portbench import spans as S


def read(run):
    spans = S.in_window(run)
    decode = Y.decode_device(run)
    d = Y.config_of(run)
    if not decode or d is None or run.peaks is None:
        return None
    prompt = {s.parent: s.counts.get("tokens", 0) for s in spans if s.name == "llm.prefill"}
    dtype = run.settings.get("compute_dtype", "bfloat16")
    need = took = 0
    for s, busy in decode:
        if s.parent in prompt:
            need += sum(Y.decode_step_bytes(d, prompt[s.parent] + j, dtype)
                        for j in range(s.counts.get("tokens", 0)))
            took += busy
    if not took:
        return None
    return 100.0 * need / run.peaks["hbm_bytes_per_s"] / took
