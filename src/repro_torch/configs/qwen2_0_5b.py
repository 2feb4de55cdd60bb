"""qwen2-0.5b [dense] — GQA kv=2, QKV bias [arXiv:2407.10671]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151936, head_dim=64,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-0.5b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
)
