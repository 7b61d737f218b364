"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn per 2 rec.
[arXiv:2402.19427; unverified]  38L d_model=4096 16H (GQA kv=1, MQA)
d_ff=12288 vocab=256000, window 2048."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, vocab_size=256_000,
    num_heads=16, num_kv_heads=1, head_dim=256,
    d_ff=12288,
    block_pattern=("rec", "rec", "attn"),
    lru_width=4096, conv_width=4, local_window=2048,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-9b-smoke", family="hybrid",
    num_layers=5, d_model=64, vocab_size=256,
    num_heads=4, num_kv_heads=1, head_dim=16, d_ff=160,
    block_pattern=("rec", "rec", "attn"),
    lru_width=64, conv_width=4, local_window=32,
    tie_embeddings=True,
)
