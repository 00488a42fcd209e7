"""mixtral-8x7b — MoE: 32L d4096 32H(kv8) ff14336 V32000, 8 experts top-2,
sliding-window attention (4096) [arXiv:2401.04088]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, rope_theta=1e6, sliding_window=4096,
    n_experts=8, top_k=2, moe_d_ff=14336, norm_eps=1e-5,
)

REDUCED = ModelConfig(
    name="mixtral-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, sliding_window=16, n_experts=4, top_k=2, moe_d_ff=160,
    q_chunk=8, kv_chunk=8,
)
