"""moonshot-v1-16b-a3b [moe] — kimi/moonlight: 64 experts top-6, 2 shared
[hf:moonshotai/Moonlight-16B-A3B]."""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163840,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="moonshot-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=96, vocab_size=512,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96,
                  num_shared_experts=1),
    tie_embeddings=True,
)
