"""llama3-405b — dense: 126L d16384 128H(kv8) ff53248 V128256
[arXiv:2407.21783]. bf16 Adam moments so params+opt fit 16 GB/chip HBM on
the single-pod mesh (DESIGN.md §5)."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
    vocab_size=128256, rope_theta=5e5, norm_eps=1e-5,
    opt_moment_dtype="bfloat16", remat_group=7,
)

REDUCED = ModelConfig(
    name="llama3-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=512, rope_theta=5e5, q_chunk=8, kv_chunk=8,
)
