"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892]. heads = d_model / 64."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_heads=64, num_kv_heads=64,
    d_ff=14336, vocab_size=65536,
    block_pattern=("rwkv",), tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="rwkv6-7b-smoke", family="ssm",
    num_layers=2, d_model=128, num_heads=2, num_kv_heads=2,
    d_ff=256, vocab_size=512,
    block_pattern=("rwkv",), tie_embeddings=False,
)
