"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]  48L d_model=2048 vocab=50280
ssm_state=128, d_inner=2·d_model, head_dim 64."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, vocab_size=50280,
    d_inner=4096, ssm_state=128, ssm_head_dim=64, ssm_groups=1,
    ssm_chunk=64, conv_width=4,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=3, d_model=64, vocab_size=256,
    d_inner=128, ssm_state=16, ssm_head_dim=16, ssm_groups=1,
    ssm_chunk=16, conv_width=4, tie_embeddings=True,
)
