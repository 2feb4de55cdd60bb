"""qwen3-0.6b [dense] — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
    d_ff=3072, vocab_size=151936, head_dim=128,
    qk_norm=True, rope_theta=1e6, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen3-0.6b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=32,
    qk_norm=True, rope_theta=1e6, tie_embeddings=True,
)
