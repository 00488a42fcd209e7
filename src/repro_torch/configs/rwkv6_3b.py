"""rwkv6-3b (Finch) — attention-free SSM: 32L d2560 ff8960 V65536,
data-dependent decay, head size 64 (40 heads) [arXiv:2404.05892]."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, d_ff=8960,
    vocab_size=65536, rope="none", ssm_type="rwkv6", rwkv_head_size=64,
    norm_eps=1e-5,
    remat_group=4,
)

REDUCED = ModelConfig(
    name="rwkv6-reduced", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=224,
    vocab_size=512, rope="none", ssm_type="rwkv6", rwkv_head_size=16,
    q_chunk=8, kv_chunk=8,
)
