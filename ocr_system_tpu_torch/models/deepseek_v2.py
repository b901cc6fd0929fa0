"""DeepSeek-V2 decoder for field extraction: multi-head latent attention
(MLA) with a latent cache, YaRN rotary embeddings, RMSNorm, and a mixture
of experts with a float32 softmax router, greedy top-k and shared experts
(DeepSeek-V2, arXiv 2405.04434 §2.1; the published ``config.json`` and
``modeling_deepseek.py`` of deepseek-ai/DeepSeek-V2-Lite).

Layer equations (``h`` the RMS-normed residual of one token):

- attention, no ``q_lora``: ``q = W_q h`` split per head into ``q_nope``
  and ``q_pe``; ``[c_kv, k_pe] = W_kva h``, ``c_kv = RMSNorm(c_kv)``, one
  ``k_pe`` per token shared by all heads; ``[k_nope, v] = W_kvb c_kv`` per
  head. ``q_pe`` and ``k_pe`` are rotated by YaRN rope (their pairs first
  de-interleaved, as ``modeling_deepseek.apply_rotary_pos_emb`` does); the
  score scale is ``(nope + rope)^-0.5 * m^2``, ``m = 0.1 * mscale_all_dim *
  ln(factor) + 1``; softmax in float32; ``W_o`` over the heads' outputs.
- the cache holds ``[c_kv, k_pe]`` per token and layer (``kv_lora_rank +
  qk_rope_head_dim`` values). Prefill attends in the expanded form (keys
  and values rebuilt from the latents); decode in the absorbed form:
  ``q~ = q_nope W_uk`` per head, ``score = q~ . c_kv + q_pe . k_pe``,
  ``o = (P c_kv) W_uv^T``.
- the first ``first_k_dense_replace`` layers have a dense SwiGLU MLP; the
  rest are MoE: router ``softmax(W_g h)`` in float32, greedy top-k, the
  weights renormalized only with ``norm_topk_prob``, times
  ``routed_scaling_factor``; each routed expert a SwiGLU of
  ``moe_intermediate_size``; the shared experts one SwiGLU of
  ``n_shared_experts * moe_intermediate_size`` added to the routed sum.

The weight rule (seeded weights, for speed and for agreement with a plain
reference; no published weights are read): each named tensor is
``torch.randn(shape, generator=torch.Generator(device).manual_seed(
name_seed(seed, name)), dtype=float32) * std``, cast to bfloat16, where
``name_seed`` mixes the seed and ``zlib.crc32(name)`` and ``std`` is
``fan_in^-0.5`` (the last axis) for every projection, the router and the
head, and 1 for the embedding; norm weights are 1. The scale is assumed
(the config gives no initializer): it keeps activations and logits of
order one through the layers. Routed experts are stacked per layer,
``experts.gate_up`` ``(E, 2 * moe_intermediate, hidden)`` (gate rows first)
and ``experts.down`` ``(E, hidden, moe_intermediate)``, so that the whole
model is drawn on the card in a few large calls. A model in float32 holds
the same bfloat16-rounded values.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import zlib

import torch
import torch.nn.functional as F

from ocr_system_tpu_torch.utils.profiler import span


@dataclasses.dataclass(frozen=True)
class DeepSeekV2Config:
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    moe_intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    n_routed_experts: int
    n_shared_experts: int
    num_experts_per_tok: int
    first_k_dense_replace: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0

    @property
    def latent_dim(self) -> int:
        """Values the cache holds per token and layer."""
        return self.kv_lora_rank + self.qk_rope_head_dim


PRESETS = {
    # https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json
    "deepseek_v2_lite": DeepSeekV2Config(
        vocab_size=102400, hidden_size=2048, intermediate_size=10944,
        moe_intermediate_size=1408, num_hidden_layers=27, num_attention_heads=16,
        n_routed_experts=64, n_shared_experts=2, num_experts_per_tok=6,
        first_k_dense_replace=1, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128),
    # for the CPU tests only
    "deepseek_v2_tiny": DeepSeekV2Config(
        vocab_size=512, hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
        num_hidden_layers=3, num_attention_heads=4, n_routed_experts=8, n_shared_experts=1,
        num_experts_per_tok=2, first_k_dense_replace=1, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
}


def name_seed(seed: int, name: str) -> int:
    """The generator seed of the tensor ``name`` under the model seed."""
    return (seed * 0x9E3779B1 + zlib.crc32(name.encode())) % (1 << 63)


def weight_specs(cfg: DeepSeekV2Config) -> list[tuple[str, tuple[int, ...], float | None]]:
    """Every tensor of the model: (name, shape, std), std None for a norm
    weight (ones)."""
    h, nh = cfg.hidden_size, cfg.num_attention_heads
    qk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim

    def proj(name, out_dim, in_dim):
        return (name, (out_dim, in_dim), in_dim ** -0.5)

    specs = [("model.embed_tokens.weight", (cfg.vocab_size, h), 1.0)]
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        specs += [
            (p + "input_layernorm.weight", (h,), None),
            proj(p + "self_attn.q_proj.weight", nh * qk, h),
            proj(p + "self_attn.kv_a_proj_with_mqa.weight", cfg.latent_dim, h),
            (p + "self_attn.kv_a_layernorm.weight", (cfg.kv_lora_rank,), None),
            proj(p + "self_attn.kv_b_proj.weight",
                 nh * (cfg.qk_nope_head_dim + cfg.v_head_dim), cfg.kv_lora_rank),
            proj(p + "self_attn.o_proj.weight", h, nh * cfg.v_head_dim),
            (p + "post_attention_layernorm.weight", (h,), None),
        ]
        if i < cfg.first_k_dense_replace:
            specs += [proj(p + "mlp.gate_proj.weight", cfg.intermediate_size, h),
                      proj(p + "mlp.up_proj.weight", cfg.intermediate_size, h),
                      proj(p + "mlp.down_proj.weight", h, cfg.intermediate_size)]
        else:
            e, m = cfg.n_routed_experts, cfg.moe_intermediate_size
            shared = cfg.n_shared_experts * m
            specs += [proj(p + "mlp.gate.weight", e, h),
                      (p + "mlp.experts.gate_up", (e, 2 * m, h), h ** -0.5),
                      (p + "mlp.experts.down", (e, h, m), m ** -0.5),
                      proj(p + "mlp.shared_experts.gate_proj.weight", shared, h),
                      proj(p + "mlp.shared_experts.up_proj.weight", shared, h),
                      proj(p + "mlp.shared_experts.down_proj.weight", h, shared)]
    specs += [("model.norm.weight", (h,), None),
              proj("lm_head.weight", cfg.vocab_size, h)]
    return specs


def make_weight(name: str, shape: tuple[int, ...], std: float | None, seed: int,
                device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """One tensor by the weight rule, bfloat16-rounded, held in ``dtype``."""
    if std is None:
        return torch.ones(shape, device=device, dtype=dtype)
    g = torch.Generator(device).manual_seed(name_seed(seed, name))
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32) * std
    return w.to(torch.bfloat16).to(dtype)


def yarn_inv_freq(cfg: DeepSeekV2Config) -> torch.Tensor:
    """The rope's inverse frequencies, float32 (``DeepseekV2YarnRotaryEmbedding``)."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta

    def correction_dim(rotations):
        return (dim * math.log(cfg.original_max_position_embeddings / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(correction_dim(cfg.beta_fast)), 0)
    high = min(math.ceil(correction_dim(cfg.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    extra = 1.0 / base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    # interpolated (divided by the factor) past the correction range
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    return extra / cfg.rope_factor * ramp + extra * (1 - ramp)


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def score_scale(cfg: DeepSeekV2Config) -> float:
    m = yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim)
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


def rope_multiplier(cfg: DeepSeekV2Config) -> float:
    """The cos/sin multiplier, ``mscale / mscale_all_dim`` of YaRN (1 as
    published)."""
    return (yarn_mscale(cfg.rope_factor, cfg.mscale)
            / yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim))


QUERY_BLOCK = 1024  # query rows whose scores the attention holds at once


class LatentCache:
    """The latent cache of one sequence: ``(layers, capacity,
    kv_lora_rank + qk_rope_head_dim)``, ``[c_kv, k_pe]`` per token,
    allocated once for the prompt and the decode budget (zeros: decode
    attends over every position, the unfilled ones masked); ``length``
    tokens are filled."""

    def __init__(self, cfg: DeepSeekV2Config, capacity: int, device, dtype):
        self.data = torch.zeros((cfg.num_hidden_layers, capacity, cfg.latent_dim),
                                device=device, dtype=dtype)
        self.length = 0

    @property
    def capacity(self) -> int:
        return self.data.shape[1]


class DeepSeekV2:
    """The decoder with seeded weights (module docstring), for inference:
    ``prefill`` into a ``LatentCache``, then ``GreedyDecoder`` through it."""

    def __init__(self, cfg: DeepSeekV2Config, seed: int, device: str | torch.device,
                 dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.w = {name: make_weight(name, shape, std, seed, self.device, dtype)
                  for name, shape, std in weight_specs(cfg)}
        self.inv_freq = yarn_inv_freq(cfg).to(self.device)
        self.scale = score_scale(cfg)
        self.rope_mult = rope_multiplier(cfg)
        nh, c = cfg.num_attention_heads, cfg.kv_lora_rank
        nope, vd = cfg.qk_nope_head_dim, cfg.v_head_dim
        # the absorbed form's per-head views of W_kvb: W_uk (nh, nope, c)
        # and W_uv (nh, v, c)
        self.w_uk, self.w_uv = [], []
        for i in range(cfg.num_hidden_layers):
            kvb = self.w[f"model.layers.{i}.self_attn.kv_b_proj.weight"].view(nh, nope + vd, c)
            self.w_uk.append(kvb[:, :nope])
            self.w_uv.append(kvb[:, nope:])

    # ---- pieces ----

    def _norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """RMSNorm in float32, cast back, times the weight
        (``DeepseekV2RMSNorm``)."""
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.cfg.rms_norm_eps)
        return self.w[name] * xf.to(x.dtype)

    def _rope_table(self, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """YaRN's cos and sin at ``positions`` (s,), float32 (s, rope_dim),
        once for all layers."""
        freqs = positions.float()[:, None] * self.inv_freq[None, :]
        emb = torch.cat((freqs, freqs), -1)
        return emb.cos() * self.rope_mult, emb.sin() * self.rope_mult

    def _rope(self, x: torch.Tensor, table: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """``x`` (..., s, rope_dim) rotated by ``table``: pairs
        de-interleaved, then rotate-half, in float32."""
        d = x.shape[-1]
        cos, sin = table
        xf = x.float()
        xf = xf.view(*x.shape[:-1], d // 2, 2).transpose(-1, -2).reshape(x.shape)
        rot = torch.cat((-xf[..., d // 2:], xf[..., : d // 2]), -1)
        return (xf * cos + rot * sin).to(x.dtype)

    def _swiglu(self, x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                down: torch.Tensor) -> torch.Tensor:
        return F.linear(F.silu(F.linear(x, gate)) * F.linear(x, up), down)

    def _attention(self, i: int, h: torch.Tensor, positions: torch.Tensor, cache: LatentCache,
                   absorbed: bool, table: tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """Attention of ``h`` (s, hidden), the tokens at ``positions`` (s,)
        with their rope ``table``: their latents written into the cache,
        then a causal attention over the cached tokens. Expanded: the
        positions follow ``cache.length`` and the keys are the filled
        part. Absorbed: the positions may live on the card only (nothing is
        read back); every position of the cache is attended, those past
        the query masked."""
        cfg, p = self.cfg, f"model.layers.{i}.self_attn."
        s = h.shape[0]
        nh, nope, rope, c = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                             cfg.qk_rope_head_dim, cfg.kv_lora_rank)
        q = F.linear(h, self.w[p + "q_proj.weight"]).view(s, nh, nope + rope).transpose(0, 1)
        q_nope, q_pe = q[..., :nope], self._rope(q[..., nope:], table)
        kva = F.linear(h, self.w[p + "kv_a_proj_with_mqa.weight"])
        latent = torch.cat((self._norm(kva[:, :c], p + "kv_a_layernorm.weight"),
                            self._rope(kva[:, c:], table)), -1)
        if absorbed:
            cache.data[i].index_copy_(0, positions, latent)
            total = cache.capacity
        else:
            start = cache.length
            cache.data[i, start: start + s] = latent
            total = start + s
        c_kv = cache.data[i, :total, :c]
        if absorbed:
            q_cat = torch.cat((torch.bmm(q_nope, self.w_uk[i]), q_pe), -1)  # (nh, s, c + rope)
            keys, values = cache.data[i, :total].T, c_kv
        else:
            kv = F.linear(c_kv, self.w[p + "kv_b_proj.weight"]).view(total, nh, -1)
            k_pe = cache.data[i, :total, None, c:].expand(total, nh, rope)
            q_cat = torch.cat((q_nope, q_pe), -1)
            keys = torch.cat((kv[..., :nope], k_pe), -1).permute(1, 2, 0)  # (nh, qk, total)
            values = kv[..., nope:].transpose(0, 1)  # (nh, total, v)
        key_pos = torch.arange(total, device=h.device)
        # a block of query rows at a time bounds the float32 scores
        outs = []
        for lo in range(0, s, QUERY_BLOCK):
            scores = torch.matmul(q_cat[:, lo: lo + QUERY_BLOCK], keys).float() * self.scale
            scores = scores.masked_fill(key_pos > positions[lo: lo + QUERY_BLOCK, None],
                                        float("-inf"))
            outs.append(torch.matmul(scores.softmax(-1).to(h.dtype), values))
        out = outs[0] if len(outs) == 1 else torch.cat(outs, 1)
        if absorbed:
            out = torch.bmm(out, self.w_uv[i].transpose(1, 2))  # (nh, s, v)
        out = out.transpose(0, 1).reshape(s, nh * cfg.v_head_dim)
        return F.linear(out, self.w[p + "o_proj.weight"])

    def _route(self, i: int, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The router in float32: (weights, experts), each (s, k)."""
        cfg = self.cfg
        logits = F.linear(h.float(), self.w[f"model.layers.{i}.mlp.gate.weight"].float())
        weights, experts = logits.softmax(-1).topk(cfg.num_experts_per_tok, dim=-1)
        if cfg.norm_topk_prob:
            weights = weights / weights.sum(-1, keepdim=True)
        return weights * cfg.routed_scaling_factor, experts

    def _mlp(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """The dense MLP, or the MoE layer: grouped by expert for many
        tokens (one read of the expert counts, a ``device_sync``), the
        chosen experts' stacked weights gathered on the card for one."""
        cfg, p = self.cfg, f"model.layers.{i}.mlp."
        if i < cfg.first_k_dense_replace:
            return self._swiglu(h, self.w[p + "gate_proj.weight"], self.w[p + "up_proj.weight"],
                                self.w[p + "down_proj.weight"])
        weights, experts = self._route(i, h)
        gate_up, down = self.w[p + "experts.gate_up"], self.w[p + "experts.down"]
        m, (s, k) = cfg.moe_intermediate_size, experts.shape
        if s == 1:
            idx = experts[0]
            x = h.expand(k, -1)[:, :, None]  # (k, hidden, 1)
            # indexing gathers at 2.7 TB/s on an H100, index_select at 1.0
            gu = torch.bmm(gate_up[idx], x)[..., 0]
            act = (F.silu(gu[:, :m]) * gu[:, m:])[:, :, None]
            outs = torch.bmm(down[idx], act)[..., 0]  # (k, hidden)
        else:
            flat = experts.reshape(-1)
            order = flat.argsort(stable=True)
            counts = torch.bincount(flat, minlength=cfg.n_routed_experts)
            with span("device_sync"):
                counts = counts.tolist()
            xs = h[order // k]
            sorted_out = torch.empty_like(xs)
            lo = 0
            for e, n in enumerate(counts):
                if n:
                    gu = F.linear(xs[lo: lo + n], gate_up[e])
                    sorted_out[lo: lo + n] = F.linear(F.silu(gu[:, :m]) * gu[:, m:], down[e])
                    lo += n
            outs = torch.empty_like(xs)
            outs[order] = sorted_out
        routed = (outs.view(s, k, -1).float() * weights[..., None]).sum(1).to(h.dtype)
        return routed + self._shared_experts(i, h)

    def _shared_experts(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """The shared experts, one SwiGLU of ``n_shared_experts`` widths."""
        p = f"model.layers.{i}.mlp.shared_experts."
        return self._swiglu(h, self.w[p + "gate_proj.weight"], self.w[p + "up_proj.weight"],
                            self.w[p + "down_proj.weight"])

    def _layers(self, ids: torch.Tensor, positions: torch.Tensor, cache: LatentCache,
                absorbed: bool, spans: bool) -> torch.Tensor:
        """Every layer over the tokens ``ids`` (s,) at ``positions`` (s,);
        the final norm's output (s, hidden). ``spans``: an ``llm.attn`` and
        an ``llm.moe`` span per layer (the dense MLP's, in the leading
        dense layers)."""
        x = F.embedding(ids, self.w["model.embed_tokens.weight"])
        table = self._rope_table(positions)
        for i in range(self.cfg.num_hidden_layers):
            p = f"model.layers.{i}."
            with span("llm.attn") if spans else contextlib.nullcontext():
                x = x + self._attention(i, self._norm(x, p + "input_layernorm.weight"),
                                        positions, cache, absorbed, table)
            with span("llm.moe") if spans else contextlib.nullcontext():
                x = x + self._mlp(i, self._norm(x, p + "post_attention_layernorm.weight"))
        return self._norm(x, "model.norm.weight")

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return F.linear(hidden, self.w["lm_head.weight"]).float()

    # ---- entry point ----

    @torch.inference_mode()
    def prefill(self, ids: torch.Tensor, capacity: int) -> tuple[torch.Tensor, LatentCache]:
        """The prompt ``ids`` (s,) in the expanded form into a new cache of
        ``capacity`` positions: the last position's float32 logits
        (vocab,), and the cache."""
        cache = LatentCache(self.cfg, capacity, self.device, self.dtype)
        positions = torch.arange(ids.shape[0], device=self.device)
        hidden = self._layers(ids, positions, cache, absorbed=False, spans=True)
        cache.length = ids.shape[0]
        return self.logits(hidden[-1]), cache


class GreedyDecoder:
    """Decoding at batch 1 after a prefill: each step feeds an id at the
    next position, decodes it in the absorbed form, keeps its float32
    logits (``logits``, (vocab,)) and puts their argmax in the id's place,
    so that the next step feeds it (greedy; the id and the position are
    held on the device, never read back), unless the caller feeds its own
    (teacher forcing). On the card the step is one CUDA graph, captured
    here for this cache (a warm-up step first, on a side stream, whose id
    and position are then put back; the position it wrote is written again
    by the first step); elsewhere it runs eagerly. The capture forbids
    unsafe CUDA calls in this thread only, so that other threads may
    allocate, copy and wait for their streams meanwhile (the server's
    uploads run in threads of their own). Another thread's device-wide
    synchronise, a new pool stream that wraps round to the capture's, or
    a draw from the default CUDA generator would still be refused during
    the capture; the served path makes none."""

    def __init__(self, model: DeepSeekV2, cache: LatentCache, first: torch.Tensor):
        self.model, self.cache = model, cache
        self.ids = first.reshape(1).clone()
        self.positions = torch.full((1,), cache.length, device=model.device)
        self.logits: torch.Tensor | None = None
        self.graph = None
        if model.device.type == "cuda":
            ids, positions = self.ids.clone(), self.positions.clone()
            side = torch.cuda.Stream(model.device)
            side.wait_stream(torch.cuda.current_stream(model.device))
            with torch.cuda.stream(side):
                self._step()
            torch.cuda.current_stream(model.device).wait_stream(side)
            self.ids.copy_(ids)
            self.positions.copy_(positions)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                self._step()

    @torch.inference_mode()
    def _step(self) -> None:
        m = self.model
        hidden = m._layers(self.ids, self.positions, self.cache, absorbed=True, spans=False)
        self.logits = m.logits(hidden[-1])
        self.ids.copy_(self.logits.argmax().reshape(1))
        self.positions.add_(1)

    def step(self, ids: torch.Tensor | None = None) -> torch.Tensor:
        """The next id (1,), on the device: the argmax of the logits of the
        last id, or of ``ids`` (1,) where given."""
        if self.cache.length >= self.cache.capacity:
            raise ValueError(f"latent cache full at {self.cache.capacity} positions")
        if ids is not None:
            self.ids.copy_(ids.reshape(1))
        if self.graph is not None:
            self.graph.replay()
        else:
            self._step()
        self.cache.length += 1
        return self.ids
