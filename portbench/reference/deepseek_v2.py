"""A plain reference of the DeepSeek-V2 decoder: the full causal forward
in float32 ``torch`` operations, with the expanded latent attention, no
cache and no batching, computed one layer at a time (each layer's weights
rebuilt from the seed, used and let go), so that a long teacher-forced
pass fits beside nothing else on the card. It imports nothing of the
program and nothing of JAX.

Written from the published ``config.json`` (read here as a dict of its
keys) and ``modeling_deepseek.py`` of deepseek-ai/DeepSeek-V2-Lite, and
the DeepSeek-V2 paper (arXiv 2405.04434 §2.1). Departures from the
modeling code:

- weights are seeded, by the rule of the program's model file: each named
  tensor ``randn(shape, Generator(device).manual_seed((seed * 0x9E3779B1 +
  crc32(name)) % 2**63), float32) * std``, rounded to bfloat16 (``std``
  ``fan_in^-0.5`` for projections, router and head, 1 for the embedding;
  norm weights 1); routed experts stacked per layer (``experts.gate_up``,
  gate rows first, and ``experts.down``);
- the rope's cos and sin and the router stay in float32 (the modeling code
  casts cos and sin to the model's dtype);
- the routed experts' outputs are summed with their weights in float32,
  as ``moe_infer`` does, in another order.

``FP8`` is the control, the precision below the configuration's bfloat16:
tensors in bfloat16, every matrix product's inputs rounded to float8 e4m3
with one scale per tensor.
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8 e4m3 value


class Precision:
    """``FP32``: float32 throughout. ``FP8``: tensors in bfloat16, each
    matrix product's inputs through a per-tensor-scaled float8 e4m3 round
    trip."""

    def __init__(self, dtype: torch.dtype = torch.float32, fp8: bool = False):
        self.dtype = dtype
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.fp8:
            return x
        amax = x.detach().abs().amax().float()
        scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
        return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.q(a), self.q(b))


FP32 = Precision()
FP8 = Precision(torch.bfloat16, fp8=True)


def set_exact_float32() -> None:
    """TF32 off, so that float32 means float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class Config:
    vocab: int
    hidden: int
    dense_width: int
    expert_width: int
    layers: int
    heads: int
    experts: int
    shared: int
    top_k: int
    dense_layers: int
    rank: int
    nope: int
    rope: int
    v: int
    eps: float
    theta: float
    factor: float
    original_max: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float
    norm_topk: bool
    routed_scale: float


def config(d: dict) -> Config:
    """The configuration from the keys of a DeepSeek-V2 ``config.json``;
    what this reference does not implement raises."""
    unsupported = {"q_lora_rank": None, "scoring_func": "softmax", "topk_method": "greedy",
                   "moe_layer_freq": 1, "hidden_act": "silu", "n_group": 1, "topk_group": 1,
                   "attention_bias": False, "tie_word_embeddings": False}
    for key, want in unsupported.items():
        if d.get(key, want) != want:
            raise ValueError(f"{key}={d[key]!r} is not implemented here")
    r = d["rope_scaling"]
    if r.get("type", "yarn") != "yarn":
        raise ValueError(f"rope_scaling {r!r} is not implemented here")
    return Config(
        vocab=d["vocab_size"], hidden=d["hidden_size"], dense_width=d["intermediate_size"],
        expert_width=d["moe_intermediate_size"], layers=d["num_hidden_layers"],
        heads=d["num_attention_heads"], experts=d["n_routed_experts"],
        shared=d["n_shared_experts"], top_k=d["num_experts_per_tok"],
        dense_layers=d["first_k_dense_replace"], rank=d["kv_lora_rank"],
        nope=d["qk_nope_head_dim"], rope=d["qk_rope_head_dim"], v=d["v_head_dim"],
        eps=d["rms_norm_eps"], theta=d["rope_theta"], factor=r["factor"],
        original_max=r["original_max_position_embeddings"], beta_fast=r["beta_fast"],
        beta_slow=r["beta_slow"], mscale=r["mscale"], mscale_all_dim=r["mscale_all_dim"],
        norm_topk=d["norm_topk_prob"], routed_scale=d["routed_scaling_factor"])


# ---- the weight rule ----

def layer_specs(c: Config, i: int) -> list[tuple[str, tuple, float | None]]:
    """(name, shape, std) of layer ``i``'s tensors; std None for ones."""
    p = f"model.layers.{i}."
    out = [(p + "input_layernorm.weight", (c.hidden,), None),
           (p + "self_attn.q_proj.weight", (c.heads * (c.nope + c.rope), c.hidden),
            c.hidden ** -0.5),
           (p + "self_attn.kv_a_proj_with_mqa.weight", (c.rank + c.rope, c.hidden),
            c.hidden ** -0.5),
           (p + "self_attn.kv_a_layernorm.weight", (c.rank,), None),
           (p + "self_attn.kv_b_proj.weight", (c.heads * (c.nope + c.v), c.rank), c.rank ** -0.5),
           (p + "self_attn.o_proj.weight", (c.hidden, c.heads * c.v), (c.heads * c.v) ** -0.5),
           (p + "post_attention_layernorm.weight", (c.hidden,), None)]
    if i < c.dense_layers:
        f = c.dense_width
        return out + [(p + "mlp.gate_proj.weight", (f, c.hidden), c.hidden ** -0.5),
                      (p + "mlp.up_proj.weight", (f, c.hidden), c.hidden ** -0.5),
                      (p + "mlp.down_proj.weight", (c.hidden, f), f ** -0.5)]
    m, sh = c.expert_width, c.shared * c.expert_width
    return out + [(p + "mlp.gate.weight", (c.experts, c.hidden), c.hidden ** -0.5),
                  (p + "mlp.experts.gate_up", (c.experts, 2 * m, c.hidden), c.hidden ** -0.5),
                  (p + "mlp.experts.down", (c.experts, c.hidden, m), m ** -0.5),
                  (p + "mlp.shared_experts.gate_proj.weight", (sh, c.hidden), c.hidden ** -0.5),
                  (p + "mlp.shared_experts.up_proj.weight", (sh, c.hidden), c.hidden ** -0.5),
                  (p + "mlp.shared_experts.down_proj.weight", (c.hidden, sh), sh ** -0.5)]


def outer_specs(c: Config) -> list[tuple[str, tuple, float | None]]:
    return [("model.embed_tokens.weight", (c.vocab, c.hidden), 1.0),
            ("model.norm.weight", (c.hidden,), None),
            ("lm_head.weight", (c.vocab, c.hidden), c.hidden ** -0.5)]


def weight(name: str, shape: tuple, std: float | None, seed: int, device) -> torch.Tensor:
    """One tensor, bfloat16-rounded, as float32."""
    if std is None:
        return torch.ones(shape, device=device)
    g = torch.Generator(device).manual_seed((seed * 0x9E3779B1 + zlib.crc32(name.encode()))
                                            % (1 << 63))
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32) * std
    return w.to(torch.bfloat16).float()


def weights(specs, seed: int, device, prec: Precision = FP32) -> dict[str, torch.Tensor]:
    return {n: weight(n, s, std, seed, device).to(prec.dtype) for n, s, std in specs}


# ---- the layers ----

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    return w * (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)).to(x.dtype)


def yarn_mscale(factor: float, m: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def inv_freq(c: Config) -> torch.Tensor:
    """YaRN's inverse frequencies: the interpolated ones (``/ factor``)
    below the correction range, the original ones above, a linear ramp
    between."""
    d = c.rope

    def corr(rot):
        return d * math.log(c.original_max / (rot * 2 * math.pi)) / (2 * math.log(c.theta))

    low = max(math.floor(corr(c.beta_fast)), 0)
    high = min(math.ceil(corr(c.beta_slow)), d - 1)
    if low == high:
        high += 0.001
    exps = torch.arange(0, d, 2, dtype=torch.float32) / d
    extrapolated = 1.0 / c.theta ** exps
    interpolated = extrapolated / c.factor
    keep = 1.0 - ((torch.arange(d // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    return interpolated * (1 - keep) + extrapolated * keep


def rope(x: torch.Tensor, c: Config) -> torch.Tensor:
    """``x`` (s, ..., rope) rotated at positions 0..s-1: its pairs
    de-interleaved, then rotate-half, in float32."""
    s, d = x.shape[0], x.shape[-1]
    f = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv_freq(c).to(x.device)
    mult = yarn_mscale(c.factor, c.mscale) / yarn_mscale(c.factor, c.mscale_all_dim)
    emb = torch.cat((f, f), -1).view(s, *([1] * (x.dim() - 2)), d)
    xf = x.float().unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat((-xf[..., d // 2:], xf[..., : d // 2]), -1)
    return (xf * emb.cos() * mult + rot * emb.sin() * mult).to(x.dtype)


def attention(c: Config, w: dict, p: str, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Causal MLA over the whole sequence ``x`` (s, hidden), expanded."""
    s = x.shape[0]
    q = prec.mm(x, w[p + "q_proj.weight"].T).view(s, c.heads, c.nope + c.rope)
    q = torch.cat((q[..., : c.nope], rope(q[..., c.nope:], c)), -1)
    kva = prec.mm(x, w[p + "kv_a_proj_with_mqa.weight"].T)
    c_kv = rms_norm(kva[:, : c.rank], w[p + "kv_a_layernorm.weight"], c.eps)
    k_pe = rope(kva[:, c.rank:], c)
    kv = prec.mm(c_kv, w[p + "kv_b_proj.weight"].T).view(s, c.heads, c.nope + c.v)
    k = torch.cat((kv[..., : c.nope], k_pe[:, None].expand(s, c.heads, c.rope)), -1)
    m = yarn_mscale(c.factor, c.mscale_all_dim)
    scores = prec.mm(q.transpose(0, 1), k.permute(1, 2, 0)).float() * ((c.nope + c.rope) ** -0.5
                                                                        * m * m)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = scores.masked_fill(~causal, float("-inf")).softmax(-1).to(x.dtype)
    out = prec.mm(probs, kv[..., c.nope:].transpose(0, 1))  # (heads, s, v)
    return prec.mm(out.transpose(0, 1).reshape(s, c.heads * c.v), w[p + "o_proj.weight"].T)


def swiglu(x, gate, up, down, prec: Precision):
    return prec.mm(F.silu(prec.mm(x, gate.T)) * prec.mm(x, up.T), down.T)


def mlp(c: Config, w: dict, p: str, i: int, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """The dense MLP, or the MoE layer: float32 softmax router, greedy
    top-k, each expert over the tokens routed to it, the shared experts."""
    if i < c.dense_layers:
        return swiglu(x, w[p + "gate_proj.weight"], w[p + "up_proj.weight"],
                      w[p + "down_proj.weight"], prec)
    probs = prec.mm(x.float(), w[p + "gate.weight"].float().T).softmax(-1)
    top, experts = probs.topk(c.top_k, dim=-1)
    if c.norm_topk:
        top = top / top.sum(-1, keepdim=True)
    top = top * c.routed_scale
    m = c.expert_width
    routed = torch.zeros(x.shape[0], c.hidden, device=x.device)
    for e in range(c.experts):
        tok, slot = (experts == e).nonzero(as_tuple=True)
        if len(tok):
            gu = w[p + "experts.gate_up"][e]
            out = swiglu(x[tok], gu[:m], gu[m:], w[p + "experts.down"][e], prec)
            routed.index_add_(0, tok, out.float() * top[tok, slot, None])
    shared = swiglu(x, w[p + "shared_experts.gate_proj.weight"],
                    w[p + "shared_experts.up_proj.weight"],
                    w[p + "shared_experts.down_proj.weight"], prec)
    return routed.to(x.dtype) + shared


def forward(c: Config, seed: int, seqs: list[torch.Tensor], device, prec: Precision = FP32,
            rows: list | None = None, held: dict | None = None) -> list[torch.Tensor]:
    """Each token sequence (s,) through the whole model, one layer at a
    time for all sequences: float32 logits (len(rows), vocab) at each
    sequence's ``rows`` (default: every position). Each layer's weights
    are made, used and let go, unless ``held`` (a dict) keeps every weight
    once made, for many passes over one model where memory allows."""
    def get(specs) -> dict[str, torch.Tensor]:
        if held is None:
            return weights(specs, seed, device, prec)
        held.update(weights([x for x in specs if x[0] not in held], seed, device, prec))
        return {n: held[n] for n, _, _ in specs}

    outer = {n: (n, s, std) for n, s, std in outer_specs(c)}
    emb = get([outer["model.embed_tokens.weight"]])["model.embed_tokens.weight"]
    xs = [emb[ids.to(device)] for ids in seqs]
    del emb
    with torch.no_grad():
        for i in range(c.layers):
            w = get(layer_specs(c, i))
            p = f"model.layers.{i}."
            for k, x in enumerate(xs):
                x = x + attention(c, w, p + "self_attn.",
                                  rms_norm(x, w[p + "input_layernorm.weight"], c.eps), prec)
                xs[k] = x + mlp(c, w, p + "mlp.", i,
                                rms_norm(x, w[p + "post_attention_layernorm.weight"], c.eps),
                                prec)
            del w
        w = get([outer["model.norm.weight"], outer["lm_head.weight"]])
        out = []
        for k, x in enumerate(xs):
            x = x if rows is None else x[torch.as_tensor(rows[k], device=device)]
            out.append(prec.mm(rms_norm(x, w["model.norm.weight"], c.eps),
                               w["lm_head.weight"].T).float())
    return out


def greedy(c: Config, seed: int, prompt: torch.Tensor, n: int, device,
           prec: Precision = FP32) -> torch.Tensor:
    """``n`` ids after ``prompt``, each the argmax of the full forward over
    the prompt and the ids before it (no cache: the prefix is recomputed at
    every step, the weights held)."""
    held: dict = {}
    seq, out = prompt.to(device), []
    for _ in range(n):
        nxt = forward(c, seed, [seq], device, prec, [[len(seq) - 1]], held)[0][0].argmax()
        out.append(nxt)
        seq = torch.cat((seq, nxt[None]))
    return torch.stack(out)
