"""Model configuration covering all assigned architecture families.

A framework-free copy of `repro.models.config` (the port imports nothing of
`repro`), plus `torch_dtype`, which maps a config's dtype name to torch.

One `ModelConfig` describes any of: dense decoder LMs (llama-style),
MoE decoders (mixtral / qwen2-moe), hybrid attention+Mamba (jamba),
attention-free SSM (rwkv6), encoder-decoder audio (whisper backbone), and
VLM backbones (qwen2-vl). Heterogeneous stacks (jamba's 1:7 attn:mamba
interleave with MoE every other layer) are expressed as a repeating
*layer pattern*; the decoder scans over pattern repeats (blocks).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal

import torch

LayerKind = Literal["attn", "mamba", "rwkv"]
MlpKind = Literal["dense", "moe", "none"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    kind: LayerKind
    mlp: MlpKind
    cross_attn: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # attention
    rope: str = "rope"              # rope | mrope | none
    rope_theta: float = 1e6
    sliding_window: int = 0         # 0 = full attention
    attn_bias: bool = False         # qwen2 / starcoder2 use qkv bias
    attn_layer_period: int = 1      # jamba: attention every 8th layer
    attn_layer_offset: int = 0
    mlp_act: str = "silu"
    gated_mlp: bool = True

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # per-expert ffn width (0 -> d_ff)
    n_shared_experts: int = 0
    shared_d_ff: int = 0
    moe_layer_period: int = 1
    moe_layer_offset: int = 0
    router_aux_loss: float = 0.01

    # SSM (mamba / rwkv6)
    ssm_type: str = ""              # "" | mamba | rwkv6
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0            # 0 -> ceil(d_model/16)
    rwkv_head_size: int = 64
    rwkv_decay_lora: int = 64
    rwkv_mix_lora: int = 32

    # encoder-decoder (whisper backbone)
    encoder_layers: int = 0
    encoder_seq: int = 0            # precomputed frame embeddings length

    # modality frontend stub: "tokens" (LM) or "embeds" (vlm/audio encoder)
    input_mode: str = "tokens"

    # numerics / distribution
    dtype: str = "bfloat16"
    # "" (full precision) | "int8": symmetric per-channel int8 expert
    # weights + int8 KV storage — the KT2-flip configuration
    # (models.layers.moe_expert_ffn_q8, DESIGN.md §15)
    quant: str = ""
    norm_eps: float = 1e-5
    # pad embedding/unembedding vocab dim to a multiple (Megatron-style) so
    # vocab-parallel sharding divides; pad logits are masked in forward.
    vocab_pad_multiple: int = 128
    tie_embeddings: bool = False
    scan_layers: bool = True
    remat: bool = True
    # scan over groups of `remat_group` pattern-repeats: boundaries are
    # saved every remat_group blocks (K-fewer stacked residuals; backward
    # recomputes the group). Must divide n_blocks.
    remat_group: int = 1
    opt_moment_dtype: str = "float32"
    # attention chunking for long sequences (pure-JAX flash)
    q_chunk: int = 512
    kv_chunk: int = 1024
    # ssm sequence chunk
    ssm_chunk: int = 64

    # ----------------------------------------------------------------- #
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        if m <= 1 or self.vocab_size % m == 0:
            return self.vocab_size
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or math.ceil(self.d_model / 16)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def layer_pattern(self) -> list[LayerSpec]:
        """The repeating block the decoder scans over."""
        if self.ssm_type == "rwkv6":
            return [LayerSpec("rwkv", "none")]
        period = 1
        if self.attn_layer_period > 1:
            period = self.attn_layer_period
        if self.n_experts and self.moe_layer_period > 1:
            period = _lcm(period, self.moe_layer_period)
        out = []
        for i in range(period):
            if self.attn_layer_period > 1:
                kind: LayerKind = ("attn" if i % self.attn_layer_period ==
                                   self.attn_layer_offset else "mamba")
            else:
                kind = "attn"
            if self.n_experts:
                is_moe = (i % self.moe_layer_period) == self.moe_layer_offset
                mlp: MlpKind = "moe" if is_moe else "dense"
            else:
                mlp = "dense"
            out.append(LayerSpec(kind, mlp, cross_attn=bool(self.encoder_layers)))
        assert self.n_layers % len(out) == 0, (self.name, self.n_layers, len(out))
        return out

    @property
    def n_blocks(self) -> int:
        return self.n_layers // len(self.layer_pattern())

    # ------------------------- parameter counting ---------------------- #
    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        n = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        if self.attn_bias:
            n += (self.n_heads + 2 * self.n_kv_heads) * hd
        return n

    def _dense_mlp_params(self, ff: int | None = None) -> int:
        f = ff or self.d_ff
        return (3 if self.gated_mlp else 2) * self.d_model * f

    def _moe_params(self, active_only: bool) -> int:
        fe = self.moe_d_ff or self.d_ff
        n_e = self.top_k if active_only else self.n_experts
        n = n_e * (3 if self.gated_mlp else 2) * self.d_model * fe
        n += self.d_model * self.n_experts  # router
        if self.n_shared_experts:
            n += self._dense_mlp_params(self.shared_d_ff or
                                        self.n_shared_experts * fe)
        return n

    def _mamba_params(self) -> int:
        d, di, ds = self.d_model, self.d_inner, self.ssm_d_state
        return (d * 2 * di + self.ssm_d_conv * di
                + di * (self.dt_rank + 2 * ds) + self.dt_rank * di
                + di * ds + di + di * d)

    def _rwkv_params(self) -> int:
        d, f = self.d_model, self.d_ff
        att = 4 * d * d + d * d  # r,k,v,g,o projections
        att += 2 * self.rwkv_decay_lora * d + 5 * 2 * self.rwkv_mix_lora * d
        att += self.d_model  # time_faaaa
        cmix = d * f + f * d + d * d
        return att + cmix

    def param_count(self, active_only: bool = False) -> int:
        """Total (or MoE-active) parameter count, used for MODEL_FLOPS."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        per_pattern = 0
        for spec in self.layer_pattern():
            if spec.kind == "attn":
                per_pattern += self._attn_params()
                if spec.cross_attn:
                    per_pattern += self._attn_params()
            elif spec.kind == "mamba":
                per_pattern += self._mamba_params()
            elif spec.kind == "rwkv":
                per_pattern += self._rwkv_params()
            if spec.mlp == "dense":
                per_pattern += self._dense_mlp_params()
            elif spec.mlp == "moe":
                per_pattern += self._moe_params(active_only)
            per_pattern += 2 * self.d_model  # norms
        n += self.n_blocks * per_pattern
        n += self.d_model  # final norm
        if self.encoder_layers:
            n += self.encoder_layers * (self._attn_params()
                                        + self._dense_mlp_params()
                                        + 2 * self.d_model)
        return n

    def model_flops(self, *, tokens: int, train: bool) -> float:
        """The spec's MODEL_FLOPS: 6*N*D (train) or 2*N*D (inference),
        with N = active params for MoE."""
        n_active = self.param_count(active_only=True)
        return (6.0 if train else 2.0) * n_active * tokens


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


_TORCH_DTYPES = {"float64": torch.float64, "float32": torch.float32,
                 "bfloat16": torch.bfloat16, "int32": torch.int32}


def torch_dtype(name: str) -> torch.dtype:
    """The `torch.dtype` named by a config or `ParamDef` dtype string."""
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; have {sorted(_TORCH_DTYPES)}")
    return _TORCH_DTYPES[name]
