"""qwen2-moe-a2.7b — MoE: 24L d2048 16H(kv16) expert-ff1408 V151936,
60 routed experts top-4 + 4 shared (shared ff 5632)
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=5632,
    vocab_size=151936, rope_theta=1e6, attn_bias=True,
    n_experts=60, top_k=4, moe_d_ff=1408,
    n_shared_experts=4, shared_d_ff=5632, norm_eps=1e-6,
)

REDUCED = ModelConfig(
    name="qwen2-moe-reduced", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
    vocab_size=512, attn_bias=True, n_experts=6, top_k=2, moe_d_ff=48,
    n_shared_experts=2, shared_d_ff=160, q_chunk=8, kv_chunk=8,
)
