"""olmo-1b [dense] — non-parametric LayerNorm [arXiv:2402.00838]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b", family="dense",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    norm_type="ln_nonparam", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="olmo-1b-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512,
    norm_type="ln_nonparam", tie_embeddings=True,
)
