"""The generative extractor's served tokens against the plain float32
DeepSeek-V2 of ``reference/deepseek_v2.py``, captured where the program
generates them (``DeepSeekV2Extractor.generate``: the prompt's ids in, the
served ids out), on every run.

After the window the reference runs teacher-forced over each kept prompt
and its served ids, one layer at a time on the card (each layer's weights
made from the configuration's seed by the program's weight rule, used and
let go). At every served id it takes the reference's best logit less the
served id's logit, over the standard deviation of that row's logits; the
number is the mean over the kept ids. With ``control`` the control (the
reference in bfloat16 with float8 products) chooses the ids in the
program's place: at each served position its own best id after the same
prefix (teacher-forced on the program's ids, in one pass; generating its
own 512 ids a document, the prefix recomputed at each step, took 3.6 s a
step on the card).
"""

from __future__ import annotations

import torch

from portbench.reference import deepseek_v2 as R

CAPTURE = "ocr_system_tpu_torch.extract.llm:DeepSeekV2Extractor.generate"
KEEP = 2


def keep(args, kwargs, out):
    """The prompt's ids and the served ids."""
    prompt = args[0] if args else kwargs["prompt_ids"]
    return torch.tensor(prompt, dtype=torch.long), torch.tensor(out, dtype=torch.long)


def read(kept, ctx, control=None):
    """The mean over the kept ids of (the reference's best logit less the
    served id's) over the standard deviation of the row."""
    if not kept:
        return None
    R.set_exact_float32()
    cfg = R.config(ctx.config)
    seed = ctx.settings.llm_weight_seed
    seqs = [torch.cat((p, s[:-1])) for p, s in kept]
    rows = [list(range(len(p) - 1, len(p) - 1 + len(s))) for p, s in kept]
    served = [s.to(ctx.device) for _, s in kept]
    if control is not None:
        served = [x.argmax(-1) for x in R.forward(cfg, seed, seqs, ctx.device, R.FP8, rows)]
    gaps = []
    for logits, ids in zip(R.forward(cfg, seed, seqs, ctx.device, R.FP32, rows), served):
        best = logits.max(-1).values
        gaps.append((best - logits.gather(-1, ids[:, None])[:, 0]) / logits.std(-1))
    return float(torch.cat(gaps).mean())


def shared_expert_dropped(setattr):
    """Every MoE layer without its shared experts."""
    from ocr_system_tpu_torch.models.deepseek_v2 import DeepSeekV2

    setattr(DeepSeekV2, "_shared_experts", lambda self, i, h: torch.zeros_like(h))


def topk_renormalized(setattr):
    """The chosen experts' router weights renormalized to sum to one (the
    published model does not)."""
    from ocr_system_tpu_torch.models.deepseek_v2 import DeepSeekV2

    real = DeepSeekV2._route

    def renormalized(self, i, h):
        weights, experts = real(self, i, h)
        return weights / weights.sum(-1, keepdim=True), experts

    setattr(DeepSeekV2, "_route", renormalized)


def rope_dropped(setattr):
    """No rotary embedding on the queries and keys."""
    from ocr_system_tpu_torch.models.deepseek_v2 import DeepSeekV2

    setattr(DeepSeekV2, "_rope", lambda self, x, table: x)


FAULTS = {f.__name__: f for f in (shared_expert_dropped, topk_renormalized, rope_dropped)}
