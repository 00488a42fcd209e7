"""whisper-tiny — enc-dec audio backbone: 4L enc + 4L dec, d384 6H(kv6)
ff1536 V51865 [arXiv:2212.04356]. The conv frontend is a stub: input_specs
provides precomputed frame embeddings (B, 1500, 384). TPU adaptation:
decoder uses RoPE instead of learned positions (DESIGN.md §2)."""
from ..models import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
    vocab_size=51865, rope_theta=1e4, mlp_act="gelu", gated_mlp=False,
    encoder_layers=4, encoder_seq=1500, tie_embeddings=True,
    norm_eps=1e-5,
)

REDUCED = ModelConfig(
    name="whisper-reduced", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160,
    vocab_size=512, mlp_act="gelu", gated_mlp=False, encoder_layers=2,
    encoder_seq=24, tie_embeddings=True, q_chunk=8, kv_chunk=8,
)
