"""yi-9b [dense] — llama-arch GQA kv=4 [arXiv:2403.04652]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
    d_ff=11008, vocab_size=64000,
    rope_theta=5e6, tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="yi-9b-smoke", family="dense",
    num_layers=3, d_model=96, num_heads=4, num_kv_heads=2,
    d_ff=192, vocab_size=512,
    rope_theta=5e6, tie_embeddings=False,
)
