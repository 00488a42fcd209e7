"""jamba-1.5-large-398b — hybrid: 72L d8192 64H(kv8) ff24576 V65536,
attn:mamba 1:7 interleave (attention at block position 4), MoE 16e top-2
every other layer [arXiv:2403.19887]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24576,
    vocab_size=65536, rope="none",
    attn_layer_period=8, attn_layer_offset=4,
    n_experts=16, top_k=2, moe_d_ff=24576,
    moe_layer_period=2, moe_layer_offset=1,
    ssm_type="mamba", ssm_d_state=16, ssm_d_conv=4, ssm_expand=2,
    ssm_dt_rank=256, norm_eps=1e-6,
    opt_moment_dtype="bfloat16",
)

REDUCED = ModelConfig(
    name="jamba-reduced", family="hybrid",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, rope="none", attn_layer_period=8, attn_layer_offset=4,
    n_experts=4, top_k=2, moe_d_ff=160, moe_layer_period=2,
    moe_layer_offset=1, ssm_type="mamba", ssm_dt_rank=8, ssm_chunk=8,
    q_chunk=8, kv_chunk=8,
)
