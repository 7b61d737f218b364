"""yi-6b [dense] — llama-arch GQA.  [arXiv:2403.04652; hf]
32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, vocab_size=64000,
    num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=11008,
    rope_theta=5_000_000.0,   # yi long-base rope
)

SMOKE = ModelConfig(
    name="yi-6b-smoke", family="dense",
    num_layers=2, d_model=64, vocab_size=256,
    num_heads=8, num_kv_heads=2, head_dim=8, d_ff=160,
)
