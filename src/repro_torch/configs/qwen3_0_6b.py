"""qwen3-0.6b [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-0.6B; hf]
28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    num_layers=28, d_model=1024, vocab_size=151936,
    num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=3072, qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-0.6b-smoke", family="dense",
    num_layers=2, d_model=64, vocab_size=256,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=96, qk_norm=True,
    tie_embeddings=True,
)
