"""recurrentgemma-2b [hybrid] — RG-LRU + local attention 1:2, MQA
[arXiv:2402.19427]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    block_pattern=("rglru", "rglru", "local"), sliding_window=2048,
    mlp_type="geglu", lru_width=2560, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    num_layers=6, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=128, vocab_size=512, head_dim=16,
    block_pattern=("rglru", "rglru", "local"), sliding_window=16,
    mlp_type="geglu", lru_width=64, tie_embeddings=True,
)
