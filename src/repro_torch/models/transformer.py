"""Model assembly: params and forward (train / prefill / decode) for
attention decoders with dense or routed-MoE MLPs.

Counterpart of `repro.models.transformer`. The reference scans over
blocks under `jax.checkpoint`; here a plain Python loop walks the blocks,
and each block's cache slice is a view into the stacked cache, written in
place.

Forward modes:
  * cache=None, S tokens      -> training / eval forward
  * cache given, S>1          -> prefill (writes KV, returns logits+cache)
  * cache given, S==1         -> decode step

Attention runs through `kernels.ops`: prefill (every S > 1) through the
flash-attention kernel, decode through the decode-attention kernel, full
or sliding-window (the cache is then a ring as wide as the window). MoE
layers (mixtral, qwen2-moe) run `layers.moe_forward`, with int8 experts
under `cfg.quant == "int8"`; their load-balance losses sum into `aux`.
Mamba, RWKV, cross-attention and M-RoPE raise `NotImplementedError`.
"""

from __future__ import annotations

import math

import torch

from ..device import resolve_device
from ..kernels import ops
from . import cache as cache_lib
from . import layers as L
from .config import LayerSpec, ModelConfig, torch_dtype
from .sharding import ParamDef, stack_defs, tree_map

_ZOO = "ROADMAP Queue 1, item 18"


# --------------------------------------------------------------------- #
# parameter definitions
# --------------------------------------------------------------------- #

def layer_defs(cfg: ModelConfig, spec: LayerSpec, name: str) -> dict:
    if spec.kind != "attn":
        raise NotImplementedError(
            f"{cfg.name}: {spec.kind} layers are not ported yet ({_ZOO})")
    if spec.cross_attn:
        raise NotImplementedError(
            f"{cfg.name}: cross-attention is not ported yet ({_ZOO})")
    d = {"ln1": L.norm_defs(cfg, f"{name}.ln1"),
         "attn": L.attn_defs(cfg, f"{name}.attn")}
    if spec.mlp != "none":
        d["ln2"] = L.norm_defs(cfg, f"{name}.ln2")
        d["mlp"] = (L.moe_defs(cfg, f"{name}.moe") if spec.mlp == "moe"
                    else L.mlp_defs(cfg, f"{name}.mlp"))
    return d


def param_defs(cfg: ModelConfig) -> dict:
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the encoder is not ported yet ({_ZOO})")
    v, dm = cfg.padded_vocab, cfg.d_model
    defs = {
        "embed": ParamDef((v, dm), (None, "tp"), "embed", "normal"),
        "final_norm": L.norm_defs(cfg, "final_norm"),
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((v, dm), ("vocab", "fsdp"), "unembed")
    defs["layers"] = [
        stack_defs(layer_defs(cfg, spec, f"l{i}"), cfg.n_blocks)
        for i, spec in enumerate(cfg.layer_pattern())]
    return defs


def init_params(rng, cfg: ModelConfig, device=None) -> dict:
    """Random parameters on `device` (None: the card). `rng` is a
    `torch.Generator` on that device or an int seed for one. Leaves are
    drawn in the reference's tree order with its rule: normal with scale
    1/sqrt(fan_in), fan_in = shape[-2] of the stacked tensor (0.02 for
    "small"), drawn in f32 and cast to the parameter dtype."""
    dev = resolve_device(device)
    gen = (rng if isinstance(rng, torch.Generator)
           else torch.Generator(device=dev).manual_seed(int(rng)))

    def mk(d: ParamDef):
        dt = torch_dtype(d.dtype or cfg.dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        scale = 0.02 if d.init == "small" else 1.0 / math.sqrt(fan_in)
        arr = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                          device=dev)
        return arr.mul_(scale).to(dt)

    return tree_map(mk, param_defs(cfg))


def quantize_moe_params(params, cfg: ModelConfig) -> dict:
    """`params` with the int8 expert weights of every MoE layer added under
    its `mlp` dict as `q8` (`layers.quantize_experts`), quantized once, one
    block at a time (an f32 copy of a whole stack would not fit beside the
    weights at full width). `forward` under `cfg.quant == "int8"` then
    uses them; without them it quantizes in every forward, to the same
    integers. The other leaves are shared, not copied."""
    layers = []
    for spec, lp in zip(cfg.layer_pattern(), params["layers"]):
        if spec.mlp == "moe":
            q8 = {}
            for i in range(cfg.n_blocks):
                one = L.quantize_experts(tree_map(lambda t: t[i],
                                                  lp["mlp"]))
                for n, (q, scale) in one.items():
                    if n not in q8:
                        q8[n] = tuple(t.new_empty((cfg.n_blocks,) + t.shape)
                                      for t in (q, scale))
                    q8[n][0][i], q8[n][1][i] = q, scale
            lp = dict(lp, mlp=dict(lp["mlp"], q8=q8))
        layers.append(lp)
    return dict(params, layers=layers)


# --------------------------------------------------------------------- #
# attention sub-layer with all cache modes
# --------------------------------------------------------------------- #

def _attention(x, p, cfg: ModelConfig, rope, kv_cache, index, width):
    """Returns (attn_out, new_kv_cache)."""
    s = x.shape[1]
    sin, cos = rope
    q, k, v = L._qkv(x, p, cfg, rope_sin=sin, rope_cos=cos)

    if kv_cache is None or s > 1:   # training, or prefill into a fresh cache
        new_kv = (None if kv_cache is None
                  else cache_lib.write_prefill(kv_cache, k, v))
        o = ops.flash_attention(q, k, v, causal=True,
                                window=cfg.sliding_window)
        return L.attn_out(o, p, x.dtype), new_kv

    new_kv = cache_lib.write_decode(kv_cache, k, v, index, width)
    o = L.cached_attention(q, new_kv["k"], new_kv["v"], index, cfg)
    return L.attn_out(o, p, x.dtype), new_kv


# --------------------------------------------------------------------- #
# block and stack
# --------------------------------------------------------------------- #

def block_forward(x, spec: LayerSpec, p, cfg: ModelConfig, rope,
                  cache_slice, index, width):
    """One pattern position. Returns (x, new_cache_slice, aux): aux is the
    MoE layer's load-balance loss, a Python 0.0 for a dense layer (no
    device op)."""
    aux = 0.0
    h = L.apply_norm(x, p["ln1"], cfg)
    o, new_cache = _attention(h, p["attn"], cfg, rope, cache_slice, index,
                              width)
    x = x + o
    if spec.mlp != "none":
        h = L.apply_norm(x, p["ln2"], cfg)
        if spec.mlp == "moe":
            o, aux = L.moe_forward(h, p["mlp"], cfg)
        else:
            o = L.mlp_forward(h, p["mlp"], cfg)
        x = x + o
    return x, new_cache, aux


def stack_forward(x, params, cfg: ModelConfig, rope, cache_layers, index,
                  width):
    """Walk the blocks in order, summing the layers' aux losses in the
    reference scan's order (a Python 0.0 while no MoE layer has run).
    Cache slices are views into the stacked (blocks, B, W, KVH, hd)
    tensors, so the writes land in place."""
    pattern = cfg.layer_pattern()
    aux = 0.0
    for blk in range(cfg.n_blocks):
        for i, spec in enumerate(pattern):
            lp = tree_map(lambda t: t[blk], params["layers"][i])
            sl = (None if cache_layers is None else
                  {"k": cache_layers[i]["k"][blk],
                   "v": cache_layers[i]["v"][blk]})
            x, _, a = block_forward(x, spec, lp, cfg, rope, sl, index, width)
            aux = aux + a
    return x, cache_layers, aux


# --------------------------------------------------------------------- #
# full forward
# --------------------------------------------------------------------- #

def mask_vocab_padding(logits, cfg: ModelConfig):
    """Mask Megatron-style vocab padding out of the softmax (in place)."""
    if cfg.padded_vocab != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def forward(params, cfg: ModelConfig, *, tokens, positions=None,
            cache=None):
    """Returns (logits, new_cache, aux). With a cache, the cache tensors
    are updated in place and `new_cache` shares them."""
    if cfg.rope == "mrope":
        raise NotImplementedError(
            f"{cfg.name}: M-RoPE is not ported yet ({_ZOO})")
    b, s = tokens.shape
    x = params["embed"][tokens].to(torch_dtype(cfg.dtype))
    dev = x.device

    index = (cache["index"] if cache is not None
             else torch.zeros((), dtype=torch.int32, device=dev))
    if positions is None:
        positions = index + torch.arange(s, dtype=torch.int32, device=dev)
        positions = positions[None, :].expand(b, s)
    rope = ((None, None) if cfg.rope == "none"
            else L.rope_sincos(positions, cfg))

    width = 0
    cache_layers = None
    attn_index = index
    if cache is not None:
        cache_layers = cache["layers"]
        width = cache_layers[0]["k"].shape[2]   # (blocks, B, W, KVH, hd)
        if s == 1:
            # per-row index (continuous batching: slots at skewed positions)
            attn_index = positions[:, -1]

    x, new_layers, aux = stack_forward(x, params, cfg, rope, cache_layers,
                                       attn_index, width)

    x = L.apply_norm(x, params["final_norm"], cfg)
    wv = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = mask_vocab_padding(x @ wv.to(x.dtype).t(), cfg)

    new_cache = None
    if cache is not None:
        new_index = index + s
        if s == 1:
            # global index tracks the furthest-advanced slot
            new_index = torch.maximum(
                new_index, positions[:, -1].max() + 1).to(torch.int32)
        new_cache = dict(cache, index=new_index, layers=new_layers)
    if not torch.is_tensor(aux):                           # no MoE layer
        aux = torch.zeros((), dtype=torch.float32, device=dev)
    return logits, new_cache, aux
