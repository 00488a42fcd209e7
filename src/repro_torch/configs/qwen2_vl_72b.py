"""qwen2-vl-72b — VLM backbone: 80L d8192 64H(kv8) ff29568 V152064, M-RoPE,
dynamic-resolution frontend stubbed to patch embeddings [arXiv:2409.12191]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab_size=152064, rope="mrope", rope_theta=1e6, attn_bias=True,
    input_mode="embeds", norm_eps=1e-6,
    remat_group=5,
)

REDUCED = ModelConfig(
    name="qwen2-vl-reduced", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, rope="mrope", rope_theta=1e6, attn_bias=True,
    input_mode="embeds", q_chunk=8, kv_chunk=8,
)
