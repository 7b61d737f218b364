"""musicgen-medium [audio] — decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]  48L d_model=1536 24H (kv=24) d_ff=6144 vocab=2048.
The EnCodec frontend is a STUB per the assignment: input_specs provides
precomputed frame token ids (one codebook stream of the delay pattern)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, vocab_size=2048,
    num_heads=24, num_kv_heads=24, head_dim=64,
    d_ff=6144,
)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio",
    num_layers=2, d_model=64, vocab_size=128,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
)
