"""whisper-small [audio] — enc-dec, conv frontend STUB (precomputed frame
embeddings via input_specs) [arXiv:2212.04356]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    is_encoder_decoder=True, num_encoder_layers=12, encoder_positions=1500,
    norm_type="ln", mlp_type="gelu", use_rope=False, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=512,
    is_encoder_decoder=True, num_encoder_layers=2, encoder_positions=16,
    norm_type="ln", mlp_type="gelu", use_rope=False, tie_embeddings=True,
)
