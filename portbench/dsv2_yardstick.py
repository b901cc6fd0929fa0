"""The generative extractor's useful work, worked out from the published
widths in a configuration file (the keys of DeepSeek-V2's ``config.json``)
and never from the program's tensors: the least bytes a decode step at
batch 1 moves, and the useful FLOPs of a prompt's prefill. And the time
the decode steps hold the card, from the device trace.

Nothing here reads the program's code: a later change to the model cannot
move the yardstick.
"""

from __future__ import annotations

import bisect
import json
import time
from pathlib import Path

from portbench import spans as S

CONFIGS = Path(__file__).resolve().parent / "configs"
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def config_of(run) -> dict | None:
    """The configuration file of the run (the one whose settings are the
    run's), where it has a DeepSeek-V2 model; else None."""
    for path in sorted(CONFIGS.glob("*.json")):
        d = json.loads(path.read_text())
        if d.get("settings") == run.settings and "kv_lora_rank" in d:
            return d
    return None


def _attention_params(d: dict) -> int:
    """One layer's attention projections."""
    h, nh = d["hidden_size"], d["num_attention_heads"]
    nope, rope, v, rank = (d["qk_nope_head_dim"], d["qk_rope_head_dim"], d["v_head_dim"],
                           d["kv_lora_rank"])
    return h * nh * (nope + rope) + h * (rank + rope) + rank * nh * (nope + v) + nh * v * h


def _expert_params(d: dict) -> int:
    """One routed expert (gate, up and down), or one expert width of the
    shared experts."""
    return 3 * d["hidden_size"] * d["moe_intermediate_size"]


def _moe_layers(d: dict) -> int:
    return d["num_hidden_layers"] - d["first_k_dense_replace"]


def decode_params(d: dict) -> int:
    """The parameters one decode step at batch 1 reads: every layer's
    attention and norms, the dense MLPs, per MoE layer the router, the
    shared experts and the chosen experts, the final norm, the head, and
    one row of the embedding."""
    h = d["hidden_size"]
    layers = d["num_hidden_layers"]
    per_layer = _attention_params(d) + 2 * h + d["kv_lora_rank"]
    dense = d["first_k_dense_replace"] * 3 * h * d["intermediate_size"]
    moe = _moe_layers(d) * (d["n_routed_experts"] * h + (d["n_shared_experts"]
                            + d["num_experts_per_tok"]) * _expert_params(d))
    return layers * per_layer + dense + moe + h + d["vocab_size"] * h + h


def decode_step_bytes(d: dict, prior: int, dtype: str) -> int:
    """The least bytes of one decode step: the parameters read once, the
    latent cache read over its ``prior`` positions and one position
    written, in every layer."""
    latent = d["num_hidden_layers"] * (d["kv_lora_rank"] + d["qk_rope_head_dim"])
    return DTYPE_BYTES[dtype] * (decode_params(d) + latent * (prior + 1))


def prefill_flops(d: dict, s: int) -> int:
    """Useful FLOPs of a prefill of ``s`` tokens: per token 2 x the active
    parameters (every layer's attention projections, the dense MLPs, per
    MoE layer the router and the chosen and shared experts), causal
    attention over ``s^2 / 2`` pairs per head and layer (scores over the
    query-key width and the weighted sum over the value width), and the
    head at the last position."""
    h, nh = d["hidden_size"], d["num_attention_heads"]
    active = (d["num_hidden_layers"] * _attention_params(d)
              + d["first_k_dense_replace"] * 3 * h * d["intermediate_size"]
              + _moe_layers(d) * (d["n_routed_experts"] * h + (d["n_shared_experts"]
                                  + d["num_experts_per_tok"]) * _expert_params(d)))
    qk_v = d["qk_nope_head_dim"] + d["qk_rope_head_dim"] + d["v_head_dim"]
    attention = d["num_hidden_layers"] * (s * s / 2) * nh * 2 * qk_v
    return int(2 * s * active + attention + 2 * d["vocab_size"] * h)


def _merged(intervals: list[tuple[float, float]]) -> list[list[float]]:
    """The union of (start, end) intervals as disjoint ones, in order."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clock_offset() -> float:
    """Seconds from the host's clock (``time.perf_counter``, the spans')
    to the trace's (the wall clock), as ``run.py`` takes it."""
    return time.time() - time.perf_counter()


def decode_device(run) -> list[tuple[object, float]] | None:
    """The window's ``llm.decode`` spans (one a document, around all its
    decode steps and the read of their ids), each with the seconds the card
    was busy inside it: the union of the trace's device operations between
    the span's start and end, the span moved from the host's clock onto
    the trace's. The device's own time, so that the profiler's cost on the
    host and between the graph's kernels is left out. None without a trace
    or a decode span."""
    spans = [s for s in S.in_window(run) or [] if s.name == "llm.decode"]
    trace = getattr(run, "trace", None)
    if not spans or trace is None:
        return None
    busy = _merged([(s, e) for _, s, e in trace.kernels])
    starts = [b[0] for b in busy]
    offset = clock_offset()
    out = []
    for sp in spans:
        lo, hi = sp.start_ns * 1e-9 + offset, sp.end_ns * 1e-9 + offset
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        took = 0.0
        while i < len(busy) and busy[i][0] < hi:
            took += max(0.0, min(busy[i][1], hi) - max(busy[i][0], lo))
            i += 1
        out.append((sp, took))
    return out
