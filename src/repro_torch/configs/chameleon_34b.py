"""chameleon-34b [vlm] — early-fusion, VQ image tokens.
[arXiv:2405.09818; unverified]  48L d_model=8192 64H (GQA kv=8)
d_ff=22016 vocab=65536 (text + VQ image codes in ONE vocabulary —
early fusion means the modality frontend reduces to the shared token
embedding; the VQ tokenizer itself is the stub, input_specs provides
token ids).  Chameleon uses qk-norm for stability."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, vocab_size=65536,
    num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22016, qk_norm=True,
)

SMOKE = ModelConfig(
    name="chameleon-34b-smoke", family="vlm",
    num_layers=2, d_model=64, vocab_size=256,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=160, qk_norm=True,
)
