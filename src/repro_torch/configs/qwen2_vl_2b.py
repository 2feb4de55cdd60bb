"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution; vision frontend STUB
(precomputed patch embeddings via input_specs) [arXiv:2409.12191]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936, head_dim=128,
    qkv_bias=True, mrope=True, rope_theta=1e6, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke", family="vlm",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=128, vocab_size=512, head_dim=16,
    qkv_bias=True, mrope=True, tie_embeddings=True,
)
