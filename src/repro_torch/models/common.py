"""Model configuration shared across all 10 assigned architectures (the
port's copy of ``repro/models/common.py``: data only)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture description. Hashable -> usable as a jit static arg."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None   # default d_model // num_heads

    # attention variants
    qkv_bias: bool = False           # qwen2
    qk_norm: bool = False            # qwen3
    use_rope: bool = True            # whisper: absolute sinusoidal only
    rope_theta: float = 10000.0
    mrope: bool = False              # qwen2-vl (M-RoPE sections)
    mrope_sections: Tuple[int, ...] = (16, 24, 24)
    sliding_window: int = 0          # 0 = full attention

    # norm / mlp variants
    norm_type: str = "rmsnorm"       # rmsnorm | ln | ln_nonparam (olmo)
    mlp_type: str = "swiglu"         # swiglu | gelu (whisper) | geglu (gemma)
    tie_embeddings: bool = True

    # mixture of experts
    moe: Optional[MoEConfig] = None

    # ssm / hybrid temporal mixing
    # block pattern repeated over depth, e.g. ("rglru","rglru","local") for
    # recurrentgemma; ("rwkv",) for rwkv6; ("attn",) for transformers.
    block_pattern: Tuple[str, ...] = ("attn",)
    conv_width: int = 4              # temporal conv in recurrent blocks
    lru_width: Optional[int] = None  # RG-LRU state width (default d_model)

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_positions: int = 1500    # whisper audio frames after conv stub

    # training
    dtype: str = "bfloat16"
    remat: bool = True
    remat_save: str = "nothing"      # 'nothing' | 'dots' (see layers.remat_policy)
    # Megatron-style sequence parallelism of the residual stream (shards
    # remat-saved activations over the model axis).  Off-able for the
    # baseline/optimized §Perf comparison.
    seq_parallel: bool = True
    # Context-parallel attention even when heads divide the model axis
    # (gathers the small GQA K/V instead of resharding q; see layers.py).
    cp_attention: bool = False
    # Unroll the layer loop instead of lax.scan.  The dry-run sets this so
    # cost_analysis / collective-parse see every layer (XLA's cost model
    # counts a while-loop body only once); runnable paths keep scan for
    # depth-independent compile times.
    unroll_layers: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch can decode at 500k context (no full-attn KV scan)."""
        return all(b in ("rwkv", "rglru", "local") for b in self.block_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND."""
        hd = self.resolved_head_dim
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        n_blocks = {"attn": 0, "local": 0, "rwkv": 0, "rglru": 0}
        for i in range(self.num_layers):
            n_blocks[self.block_pattern[i % len(self.block_pattern)]] += 1
        # attention blocks
        attn_p = d * hd * self.num_heads + 2 * d * hd * self.num_kv_heads \
            + hd * self.num_heads * d
        per_attn = attn_p
        # rwkv time-mix ~ 4 d^2 (+ small lora); rglru ~ 2*d*lru + lru^2-ish
        lru = self.lru_width or d
        per_rwkv = 4 * d * d + 6 * 64 * d
        per_rglru = 2 * d * lru + 2 * lru * (self.conv_width + 2)
        # mlp
        if self.moe is not None:
            ff = self.moe.d_ff_expert
            per_mlp = self.moe.num_experts * 3 * d * ff + d * self.moe.num_experts
            if self.moe.num_shared_experts:
                per_mlp += self.moe.num_shared_experts * 3 * d * ff
        elif self.mlp_type == "swiglu" or self.mlp_type == "geglu":
            per_mlp = 3 * d * self.d_ff
        else:
            per_mlp = 2 * d * self.d_ff
        total = emb
        total += n_blocks["attn"] * per_attn + n_blocks["local"] * per_attn
        total += n_blocks["rwkv"] * per_rwkv + n_blocks["rglru"] * per_rglru
        total += self.num_layers * per_mlp
        if self.is_encoder_decoder:
            # encoder self-attn + mlp + decoder cross-attn
            enc = self.num_encoder_layers * (per_attn + 2 * d * self.d_ff)
            total += enc + self.num_layers * per_attn  # cross-attention
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts) — for 6·N_active·D."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        ff = self.moe.d_ff_expert
        d = self.d_model
        all_experts = self.num_layers * self.moe.num_experts * 3 * d * ff
        active = self.num_layers * (self.moe.top_k + self.moe.num_shared_experts) * 3 * d * ff
        return int(full - all_experts + active)
