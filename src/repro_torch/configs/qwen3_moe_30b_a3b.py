"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, qk_norm
[hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=768, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=64, vocab_size=512, head_dim=32,
    qk_norm=True,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64),
    tie_embeddings=True,
)
