"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64e top-6.
[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (kv=16)
expert d_ff=1408 vocab=163840; DeepSeek-V3 arch: 1 dense lead-in,
2 shared experts."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, vocab_size=163_840,
    num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=11264,               # dense lead-in FFN (moonlight intermediate)
    num_experts=64, experts_per_token=6, moe_d_ff=1408,
    shared_experts=2, num_dense_layers=1,
    capacity_factor=1.25,
    rope_theta=50_000.0,
)

SMOKE = ModelConfig(
    name="moonshot-smoke", family="moe",
    num_layers=3, d_model=64, vocab_size=256,
    num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128,
    num_experts=8, experts_per_token=2, moe_d_ff=32,
    shared_experts=2, num_dense_layers=1,
)
