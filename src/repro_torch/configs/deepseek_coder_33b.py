"""deepseek-coder-33b — dense llama-arch: 62L d7168 56H(kv8) ff19200
V32256 [arXiv:2401.14196]. 56 q-heads don't divide the 16-way model axis:
head TP is dropped for q (recorded by the sharding planner)."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b", family="dense",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=19200,
    vocab_size=32256, rope_theta=1e5, norm_eps=1e-6,
    remat_group=2,
)

REDUCED = ModelConfig(
    name="deepseek-coder-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, rope_theta=1e5, q_chunk=8, kv_chunk=8,
)
