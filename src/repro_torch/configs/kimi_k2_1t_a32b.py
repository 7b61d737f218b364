"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table).
[arXiv:2501.kimi2; unverified]  61L d_model=7168 64H (GQA kv=8)
expert d_ff=2048, vocab=163840, MoE 384e top-8, 1 dense lead-in layer,
1 shared expert (DeepSeek-V3 lineage)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, vocab_size=163_840,
    num_heads=64, num_kv_heads=8, head_dim=112,
    d_ff=18432,               # the dense lead-in layer's FFN
    num_experts=384, experts_per_token=8, moe_d_ff=2048,
    shared_experts=1, num_dense_layers=1,
    capacity_factor=1.25,
    rope_theta=50_000.0,
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke", family="moe",
    num_layers=3, d_model=64, vocab_size=256,
    num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160,
    num_experts=8, experts_per_token=2, moe_d_ff=32,
    shared_experts=1, num_dense_layers=1,
)
