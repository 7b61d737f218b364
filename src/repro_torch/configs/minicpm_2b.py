"""minicpm-2b [dense] — WSD schedule, llama-like, depth-scaled residuals.
[arXiv:2404.06395; hf]  40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, vocab_size=122753,
    num_heads=36, num_kv_heads=36, head_dim=64,
    d_ff=5760,
    scale_depth=1.4,          # minicpm depth-scaled residuals
    tie_embeddings=True,      # minicpm ties embedding and head
    rope_theta=10_000.0,
)

# training schedule is arch-specific: WSD (the paper's contribution)
TRAIN_SCHEDULE = "wsd"

SMOKE = ModelConfig(
    name="minicpm-2b-smoke", family="dense",
    num_layers=2, d_model=64, vocab_size=256,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=160,
    scale_depth=1.4, tie_embeddings=True,
)
