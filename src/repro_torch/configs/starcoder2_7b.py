"""starcoder2-7b — dense: 32L d4608 36H(kv4) ff18432 V49152, GQA + RoPE,
sliding window 4096, layernorm + non-gated gelu MLP, attention bias
[arXiv:2402.19173]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab_size=49152, rope_theta=1e5, sliding_window=4096, attn_bias=True,
    mlp_act="gelu", gated_mlp=False, norm_eps=1e-5,
    remat_group=4,
)

REDUCED = ModelConfig(
    name="starcoder2-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, sliding_window=16, attn_bias=True, mlp_act="gelu",
    gated_mlp=False, q_chunk=8, kv_chunk=8,
)
