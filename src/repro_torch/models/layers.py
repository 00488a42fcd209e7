"""Transformer building blocks, dense part: norms, RoPE, GQA attention
projections, decode attention over the KV cache, and the dense MLP.

Counterpart of `repro.models.layers`. Weights are declared as `ParamDef`
with the same shapes: q/k/v weights stay 3-D (d_model, heads, head_dim).
Decode attention goes through `kernels.ops.decode_attention`, the CUDA
kernel on the card and its plain version on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ModelConfig
from .sharding import ParamDef


# --------------------------------------------------------------------- #
# norms
# --------------------------------------------------------------------- #

def norm_defs(cfg: ModelConfig, name: str) -> dict:
    d = {"scale": ParamDef((cfg.d_model,), (None,), f"{name}.scale", "ones")}
    if _is_layernorm(cfg):
        d["bias"] = ParamDef((cfg.d_model,), (None,), f"{name}.bias", "zeros")
    return d


def _is_layernorm(cfg: ModelConfig) -> bool:
    return cfg.name.startswith(("starcoder", "whisper"))


def apply_norm(x, p, cfg: ModelConfig):
    """RMS norm (layer norm for starcoder/whisper), computed in f32."""
    xf = x.float()
    if _is_layernorm(cfg):
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# RoPE
# --------------------------------------------------------------------- #

def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    hd = cfg.hd
    return 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def rope_sincos(positions, cfg: ModelConfig):
    """positions: (..., S) int -> sin/cos (..., S, hd/2) f32 (1-D RoPE)."""
    if cfg.rope == "mrope":
        raise NotImplementedError(
            "M-RoPE (qwen2-vl) is not ported yet: ROADMAP Queue 1, item 18")
    t = positions.float()[..., None] * rope_freqs(cfg, positions.device)
    return torch.sin(t), torch.cos(t)


def apply_rope(x, sin, cos):
    """x: (B,S,H,hd); sin/cos: (B,S,hd/2) or (S,hd/2)."""
    if sin.dim() == 2:
        sin, cos = sin[None], cos[None]
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------- #

def attn_defs(cfg: ModelConfig, name: str) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    defs = {
        "wq": ParamDef((d, h, hd), ("fsdp", "tp", None), f"{name}.wq"),
        "wk": ParamDef((d, kvh, hd), ("fsdp", "tp", None), f"{name}.wk"),
        "wv": ParamDef((d, kvh, hd), ("fsdp", "tp", None), f"{name}.wv"),
        "wo": ParamDef((h, hd, d), ("tp", None, "fsdp"), f"{name}.wo"),
    }
    if cfg.attn_bias:
        defs["bq"] = ParamDef((h, hd), ("tp", None), f"{name}.bq", "zeros")
        defs["bk"] = ParamDef((kvh, hd), ("tp", None), f"{name}.bk", "zeros")
        defs["bv"] = ParamDef((kvh, hd), ("tp", None), f"{name}.bv", "zeros")
    return defs


def _proj(x, w):
    """x (B,S,d) @ w (d, heads, hd) -> (B,S,heads,hd), one matmul."""
    d, nh, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, nh * hd)).unflatten(-1, (nh, hd))


def _qkv(x, p, cfg: ModelConfig, *, rope_sin=None, rope_cos=None):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.rope != "none" and rope_sin is not None:
        q = apply_rope(q, rope_sin, rope_cos)
        k = apply_rope(k, rope_sin, rope_cos)
    return q, k, v


def cached_attention(q, k_cache, v_cache, index, cfg: ModelConfig):
    """Decode-step attention against a (possibly ring) KV cache.

    q: (B,1,H,hd); caches: (B,W,KVH,hd); index: current position, scalar
    or per-row (B,) for continuous batching. The slots `repro`'s
    `cached_attention` keeps (`cache.slot_positions(index + 1, W)`: filled,
    at or before `index`, inside the window) are exactly the first
    min(index + 1, W) slots, for full and ring caches alike, because a
    ring's width is the window. Softmax ignores slot order, so the kernel
    only needs that count per row.
    """
    b, _, h, hd = q.shape
    w = k_cache.shape[1]
    index = torch.as_tensor(index, device=q.device)
    lengths = torch.clamp(index.reshape(-1) + 1, max=w).to(torch.int32)
    lengths = lengths.expand(b).contiguous()
    o = ops.decode_attention(q[:, 0].contiguous(), k_cache, v_cache, lengths)
    return o.reshape(b, 1, h, hd)


def attn_out(o, p, x_dtype):
    h, hd, d = p["wo"].shape
    return o.flatten(-2) @ p["wo"].to(x_dtype).reshape(h * hd, d)


# --------------------------------------------------------------------- #
# dense MLP
# --------------------------------------------------------------------- #

def mlp_defs(cfg: ModelConfig, name: str) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    defs = {
        "wu": ParamDef((d, f), ("fsdp", "tp"), f"{name}.wu"),
        "wd": ParamDef((f, d), ("tp", "fsdp"), f"{name}.wd"),
    }
    if cfg.gated_mlp:
        defs["wg"] = ParamDef((d, f), ("fsdp", "tp"), f"{name}.wg")
    return defs


def _act_fn(cfg: ModelConfig):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[cfg.mlp_act]


def mlp_forward(x, p, cfg: ModelConfig):
    act = _act_fn(cfg)
    up = x @ p["wu"].to(x.dtype)
    if cfg.gated_mlp:
        up = act(x @ p["wg"].to(x.dtype)) * up
    else:
        up = act(up)
    return up @ p["wd"].to(x.dtype)
