"""granite-3-8b — dense: 40L d4096 32H(kv8) ff12800 V49155, GQA
[hf:ibm-granite/granite-3.0-2b-base family]. Vocab 49155 is not divisible
by the model axis: vocab-parallel logits are dropped (recorded)."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=12800,
    vocab_size=49155, rope_theta=1e7, norm_eps=1e-5,
    remat_group=4,
)

REDUCED = ModelConfig(
    name="granite-reduced", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160,
    vocab_size=515, q_chunk=8, kv_chunk=8,
)
