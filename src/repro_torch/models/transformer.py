"""Model assembly: params and forward (train / prefill / decode) for every
architecture of the zoo: attention decoders with dense or routed-MoE MLPs,
the jamba hybrid (mamba and attention layers), RWKV-6, the whisper
encoder-decoder (encoder, cross-attention) and qwen2-vl (M-RoPE, `embeds`
input).

Counterpart of `repro.models.transformer`. The reference scans over
blocks under `jax.checkpoint`; here a plain Python loop walks the blocks,
and each block's cache slice is a tree of views into the stacked cache
(the nested `cross` dict included), written in place: KV rows by the cache
writers, recurrent states by `copy_`.

Forward modes:
  * cache=None, S tokens      -> training / eval forward
  * cache given, S>1          -> prefill (writes KV, returns logits+cache)
  * cache given, S==1         -> decode step

Attention runs through `kernels.ops`: prefill (every S > 1) through the
flash-attention kernel, decode through the decode-attention kernel, full
or sliding-window (the cache is then a ring as wide as the window). MoE
layers (mixtral, qwen2-moe) run `layers.moe_forward`, with int8 experts
under `cfg.quant == "int8"`; their load-balance losses sum into `aux`.
The whisper encoder's self-attention and the cross-attention of a prefill
run the flash kernel without the causal mask; a decode step's
cross-attention runs the decode kernel over the whole cached encoder K/V.
Mamba and RWKV layers are plain PyTorch (`mamba`, `rwkv`): no kernel.

Training (cache None, grad enabled): each stacked leaf is unbound once
(one `stack` in its backward, not a leaf-sized zero tensor per block) and,
under `cfg.remat`, every group of `cfg.remat_group` blocks (every encoder
layer) runs under `torch.utils.checkpoint`, the counterpart of the
reference's `jax.checkpoint`: its activations are recomputed in the
backward. The flash-attention calls then carry a gradient through the
backward kernel (`kernels.ops`). `lm_loss` is the reference's loss.

On a mesh (`shd`, parameters and inputs as DTensors) `forward` carries
the reference's activation constraints (`Shardings.act`) at the same
places, runs under `Shardings.implicit` (constants the step makes meet
DTensors as replicated), repeats K/V to all heads before the kernels
where heads are sharded (`layers.heads_for_kernel`), and the attention
wrappers run on each device's shard (`kernels.ops`). Without a mesh
every constraint is a no-op.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..kernels import ops
from ..spans import span
from . import cache as cache_lib
from . import layers as L
from .config import LayerSpec, ModelConfig, torch_dtype
from .mamba import mamba_defs, mamba_forward
from .rwkv import rwkv_channel_mix, rwkv_defs, rwkv_time_mix
from .sharding import (NO_SHARDING, ParamDef, Shardings, is_dtensor,
                       stack_defs, tree_map, tree_shape_structs, tree_specs)


# --------------------------------------------------------------------- #
# parameter definitions
# --------------------------------------------------------------------- #

def layer_defs(cfg: ModelConfig, spec: LayerSpec, name: str) -> dict:
    d = {"ln1": L.norm_defs(cfg, f"{name}.ln1")}
    if spec.kind == "attn":
        d["attn"] = L.attn_defs(cfg, f"{name}.attn")
        if spec.cross_attn:
            d["ln_cross"] = L.norm_defs(cfg, f"{name}.ln_cross")
            d["cross"] = L.attn_defs(cfg, f"{name}.cross")
    elif spec.kind == "mamba":
        d["mamba"] = mamba_defs(cfg, f"{name}.mamba")
    elif spec.kind == "rwkv":
        d["rwkv"] = rwkv_defs(cfg, f"{name}.rwkv")
        d["ln2"] = L.norm_defs(cfg, f"{name}.ln2")
        return d
    if spec.mlp != "none":
        d["ln2"] = L.norm_defs(cfg, f"{name}.ln2")
        d["mlp"] = (L.moe_defs(cfg, f"{name}.moe") if spec.mlp == "moe"
                    else L.mlp_defs(cfg, f"{name}.mlp"))
    return d


def param_defs(cfg: ModelConfig) -> dict:
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
    if cfg.encoder_layers:
        enc_spec = LayerSpec("attn", "dense", cross_attn=False)
        defs["encoder"] = {
            "layers": stack_defs(layer_defs(cfg, enc_spec, "enc"),
                                 cfg.encoder_layers),
            "final_norm": L.norm_defs(cfg, "enc.final_norm"),
        }
    return defs


def init_params(rng, cfg: ModelConfig, device=None,
                shd: Shardings | None = None) -> dict:
    """Random parameters on `device` (None: the card): `init_tree` of
    `param_defs(cfg)`; with `shd` on a mesh, DTensors of `param_specs`."""
    return init_tree(param_defs(cfg), rng, cfg, device, shd)


def param_shape_structs(cfg: ModelConfig):
    """The parameters as `meta` tensors (the dry run's stand-ins)."""
    return tree_shape_structs(param_defs(cfg), cfg.dtype)


def param_specs(cfg: ModelConfig, shd: Shardings):
    return tree_specs(shd, param_defs(cfg))


def init_tree(defs, rng, cfg: ModelConfig, device=None,
              shd: Shardings | None = None) -> dict:
    """Random tensors for a `ParamDef` tree on `device` (None: the card).
    `rng` is a `torch.Generator` on that device or an int seed for one.
    Leaves are drawn in the reference's tree order with its rule: normal
    with scale 1/sqrt(fan_in), fan_in = shape[-2] of the (stacked) tensor
    (0.02 for "small"), drawn in f32 and cast to the parameter dtype.
    With `shd` on a mesh every rank draws the whole leaf (same seed, same
    values as without a mesh) and keeps its shard of the leaf's spec."""
    dev = resolve_device(device)
    gen = (rng if isinstance(rng, torch.Generator)
           else torch.Generator(device=dev).manual_seed(int(rng)))

    def draw(d: ParamDef):
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

    def mk(d: ParamDef):
        arr = draw(d)
        if shd is not None and shd.mesh is not None:
            arr = shd.place(arr, shd.spec(d.shape, d.kinds, d.name))
        return arr

    return tree_map(mk, defs)


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

def _attention(x, p, cfg: ModelConfig, rope, kv_cache, index, width,
               shd: Shardings = NO_SHARDING):
    """Self-attention; a prefill or decode step writes its K/V into
    `kv_cache` in place. Returns attn_out."""
    s = x.shape[1]
    sin, cos = rope
    decoding = kv_cache is not None and s == 1
    q, k, v = L._qkv(x, p, cfg, shd, rope_sin=sin, rope_cos=cos,
                     heads_tp=not decoding)

    if not decoding:   # training, or prefill into a fresh cache
        if kv_cache is not None:
            cache_lib.write_prefill(kv_cache, k, v)
        q, k, v = L.heads_for_kernel(q, k, v, shd)
        o = ops.flash_attention(q, k, v, causal=True,
                                window=cfg.sliding_window)
        return L.attn_out(o, p, x.dtype, shd)

    cache_lib.write_decode(kv_cache, k, v, index, width)
    o = L.cached_attention(q, kv_cache["k"], kv_cache["v"], index, cfg, shd)
    return L.attn_out(o, p, x.dtype, shd)


def _cross_attention(x, p, cfg: ModelConfig, cross_cache, encoder_out,
                     shd: Shardings = NO_SHARDING):
    """Whisper-style cross-attention, no mask. With `encoder_out` (a
    prefill, or a training forward) the encoder K/V are computed and, if
    there is a cache, written into it; without it they are read from the
    cache. One query (a decode step) runs the decode kernel over all
    `encoder_seq` cached rows, more run the flash kernel."""
    q = L._proj(x, p["wq"], shd)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    if encoder_out is not None:
        k, v = (L._proj(encoder_out, p[n], shd) for n in ("wk", "wv"))
        if "bk" in p:
            k = k + p["bk"].to(x.dtype)
            v = v + p["bv"].to(x.dtype)
        if cross_cache is not None:
            cache_lib.write_prefill(cross_cache, k, v)
    else:
        k, v = cross_cache["k"].to(x.dtype), cross_cache["v"].to(x.dtype)
    if q.shape[1] == 1:
        o = ops.decode_attention(q[:, 0].contiguous(), k, v,
                                 k.shape[1])[:, None]
    else:
        o = ops.flash_attention(*L.heads_for_kernel(q, k, v, shd),
                                causal=False)
    return L.attn_out(o, p, x.dtype, shd)


# --------------------------------------------------------------------- #
# block and stack
# --------------------------------------------------------------------- #

def _norm(x, p, cfg: ModelConfig, shd: Shardings):
    """The block's norm, then (on a mesh) the activation gathered over
    the sequence: under sequence parallelism the norm runs on sequence
    shards and its output is all-gathered before the tensor-parallel
    products (Megatron SP); without SP or a mesh it is the norm alone."""
    return shd.act(L.apply_norm(x, p, cfg), "batch", None, None)


def _rwkv_zero_state(x, cfg: ModelConfig) -> dict:
    b = x.shape[0]
    hs = cfg.rwkv_head_size
    return {"wkv": torch.zeros((b, cfg.n_rwkv_heads, hs, hs),
                               dtype=cache_lib.state_dtype(cfg),
                               device=x.device),
            "shift_tm": x.new_zeros((b, 1, cfg.d_model)),
            "shift_cm": x.new_zeros((b, 1, cfg.d_model))}


def _write_state(cache_slice, new_state) -> None:
    """Copy a layer's new recurrent state into its cache views (in place:
    a rebound name would never reach the stacked cache). A DTensor state
    is first laid out as its cache leaf is: DTensor's `copy_` refuses a
    change of placement, and every state is row-local."""
    for name, t in new_state.items():
        dst = cache_slice[name]
        if is_dtensor(dst) and tuple(t.placements) != tuple(dst.placements):
            t = t.redistribute(dst.device_mesh, dst.placements)
        dst.copy_(t)


def block_forward(x, spec: LayerSpec, p, cfg: ModelConfig, rope,
                  cache_slice, index, width, encoder_out=None,
                  shd: Shardings = NO_SHARDING, layer: int = -1):
    """One pattern position, the `layer`-th of the stack. `cache_slice`
    (None without a cache) is the layer's tree of cache views, updated in
    place. Returns (x, aux): aux is the MoE layer's load-balance loss, a
    Python 0.0 for any other layer (no device op). The attention and the
    MLP or MoE, after their norms, are spans (`model.attn`, `model.mlp`,
    `model.moe`) with the layer's number."""
    aux = 0.0
    h = _norm(x, p["ln1"], cfg, shd)
    if spec.kind == "attn":
        with span("model.attn", layer=layer):
            x = x + _attention(h, p["attn"], cfg, rope, cache_slice, index,
                               width, shd)
            if spec.cross_attn:
                h = _norm(x, p["ln_cross"], cfg, shd)
                cc = None if cache_slice is None else cache_slice["cross"]
                x = x + _cross_attention(h, p["cross"], cfg, cc,
                                         encoder_out, shd)
    elif spec.kind == "mamba":
        o, state = mamba_forward(h, p["mamba"], cfg, cache_slice, shd)
        x = x + o
        if cache_slice is not None:
            _write_state(cache_slice, state)
    elif spec.kind == "rwkv":
        state = (cache_slice if cache_slice is not None
                 else _rwkv_zero_state(x, cfg))
        o, tm_state = rwkv_time_mix(h, p["rwkv"], cfg, state, shd)
        x = x + o
        h2 = _norm(x, p["ln2"], cfg, shd)
        o2, cm_state = rwkv_channel_mix(h2, p["rwkv"], cfg, state, shd)
        x = x + o2
        if cache_slice is not None:
            _write_state(cache_slice, {**tm_state, **cm_state})
        return x, aux

    if spec.mlp != "none":
        h = _norm(x, p["ln2"], cfg, shd)
        with span("model.moe" if spec.mlp == "moe" else "model.mlp",
                  layer=layer):
            if spec.mlp == "moe":
                o, aux = L.moe_forward(h, p["mlp"], cfg, shd)
            else:
                o = L.mlp_forward(h, p["mlp"], cfg, shd)
            x = x + o
    return shd.act(x, "batch", "seq", None), aux


def _training(cache_layers=None) -> bool:
    """A training forward: no cache and grad enabled."""
    return cache_layers is None and torch.is_grad_enabled()


def _unbound(stacked, n: int) -> list:
    """The `n` per-block trees of a stacked parameter tree, each leaf
    unbound once: `torch.unbind`'s backward stacks the blocks' gradients
    once, where indexing `t[blk]` would add a leaf-sized zero tensor per
    block."""
    split = tree_map(lambda t: t.unbind(0), stacked)
    return [tree_map(lambda u: u[i], split,
                     is_leaf=lambda x: isinstance(x, tuple)) for i in range(n)]


def stack_forward(x, params, cfg: ModelConfig, rope, cache_layers, index,
                  width, encoder_out=None, shd: Shardings = NO_SHARDING):
    """Walk the blocks in order, summing the layers' aux losses in the
    reference scan's order (a Python 0.0 while no MoE layer has run).
    Each layer's cache slice is a tree of views into the stacked
    (blocks, B, ...) tensors, so its writes land in place. A training
    forward runs the blocks in groups of `cfg.remat_group` (1 where it
    does not divide the blocks, as the reference), each group under
    `checkpoint` when `cfg.remat`."""
    pattern = cfg.layer_pattern()
    if _training(cache_layers):
        blocks = [_unbound(lp, cfg.n_blocks) for lp in params["layers"]]
        g = max(cfg.remat_group, 1)
        if cfg.n_blocks % g:
            g = 1

        def group(x, aux, blk0):
            for blk in range(blk0, blk0 + g):
                for i, spec in enumerate(pattern):
                    x, a = block_forward(x, spec, blocks[i][blk], cfg, rope,
                                         None, index, width, encoder_out,
                                         shd, blk * len(pattern) + i)
                    aux = aux + a
            return x, aux

        aux = 0.0
        for blk0 in range(0, cfg.n_blocks, g):
            if cfg.remat:
                x, aux = checkpoint(group, x, aux, blk0, use_reentrant=False)
            else:
                x, aux = group(x, aux, blk0)
        return x, None, aux

    aux = 0.0
    for blk in range(cfg.n_blocks):
        for i, spec in enumerate(pattern):
            lp = tree_map(lambda t: t[blk], params["layers"][i])
            sl = (None if cache_layers is None
                  else tree_map(lambda t: t[blk], cache_layers[i]))
            x, a = block_forward(x, spec, lp, cfg, rope, sl, index, width,
                                 encoder_out, shd, blk * len(pattern) + i)
            aux = aux + a
    return x, cache_layers, aux


# --------------------------------------------------------------------- #
# encoder (whisper backbone; frame embeddings come from the stub frontend)
# --------------------------------------------------------------------- #

def encoder_forward(embeds, params, cfg: ModelConfig,
                    shd: Shardings = NO_SHARDING):
    """The whisper encoder over frame embeddings (B, encoder_seq, D): a
    sinusoid added, then pre-norm attention layers without RoPE and
    without a mask, and a final norm. In training each layer runs under
    `checkpoint` when `cfg.remat`."""
    x = embeds + _sinusoid(cfg.encoder_seq, cfg.d_model,
                           embeds.device).to(embeds.dtype)
    x = shd.act(x, "batch", None, None)

    def layer(x, p):
        h = _norm(x, p["ln1"], cfg, shd)
        q, k, v = L._qkv(h, p["attn"], cfg, shd)
        o = ops.flash_attention(*L.heads_for_kernel(q, k, v, shd),
                                causal=False)
        x = x + L.attn_out(o, p["attn"], x.dtype, shd)
        h = _norm(x, p["ln2"], cfg, shd)
        x = x + L.mlp_forward(h, p["mlp"], cfg, shd)
        return shd.act(x, "batch", None, None)

    if _training():
        for p in _unbound(params["layers"], cfg.encoder_layers):
            x = (checkpoint(layer, x, p, use_reentrant=False) if cfg.remat
                 else layer(x, p))
    else:
        for i in range(cfg.encoder_layers):
            x = layer(x, tree_map(lambda t: t[i], params["layers"]))
    return _norm(x, params["final_norm"], cfg, shd)


def _sinusoid(s, d, device=None):
    """(1, s, d) f32: sin of position / 10000^(2i/d) in the first half,
    cos in the second."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10000.0, dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], -1)[None]


# --------------------------------------------------------------------- #
# full forward
# --------------------------------------------------------------------- #

def mask_vocab_padding(logits, cfg: ModelConfig):
    """Mask Megatron-style vocab padding out of the softmax (in place; a
    DTensor, whose vocab dim may be sharded, by a `where`)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    if is_dtensor(logits):
        keep = torch.arange(cfg.padded_vocab,
                            device=logits.device) < cfg.vocab_size
        return torch.where(keep, logits, torch.full(
            (), -1e30, dtype=logits.dtype, device=logits.device))
    logits[..., cfg.vocab_size:] = -1e30
    return logits


def forward(params, cfg: ModelConfig, *, tokens=None, embeds=None,
            positions=None, mrope_positions=None, cache=None,
            encoder_embeds=None, shd: Shardings | None = None):
    """Returns (logits, new_cache, aux); module docstring. `shd` (None: no
    mesh) carries the mesh and the policy when the parameters and inputs
    are DTensors."""
    shd = shd if shd is not None else NO_SHARDING
    with shd.implicit():
        return _forward(params, cfg, shd, tokens=tokens, embeds=embeds,
                        positions=positions,
                        mrope_positions=mrope_positions, cache=cache,
                        encoder_embeds=encoder_embeds)


def _forward(params, cfg: ModelConfig, shd: Shardings, *, tokens, embeds,
             positions, mrope_positions, cache, encoder_embeds):
    """Returns (logits, new_cache, aux). Input is `tokens` (B, S) or
    `embeds` (B, S, D); `encoder_embeds` (B, encoder_seq, D) runs the
    encoder (whisper) and, with a cache, fills its cross K/V; without
    them a decode step reads that cache. Under M-RoPE, `mrope_positions`
    (3, B, S) gives the three position streams (default: `positions` in
    all three). With a cache, the cache tensors are updated in place and
    `new_cache` shares them."""
    if embeds is not None:
        x = embeds.to(torch_dtype(cfg.dtype))
        b, s = x.shape[:2]
    else:
        b, s = tokens.shape
        # on a mesh the gather runs on each device's rows and its shard
        # of the embedding's width (DTensor has no rule for every layout
        # of an index by a row-sharded tensor, nor for its backward)
        emb = params["embed"]
        x = shd.local_with(lambda e, t: e[t], (emb, tokens),
                           ((None, "tp"), ("batch", None)),
                           (((b, s, emb.shape[1]), ("batch", None, "tp")),))
        x = x.to(torch_dtype(cfg.dtype))
    x = shd.act(x, "batch", None, None)
    dev = x.device

    index = (cache["index"] if cache is not None
             else torch.zeros((), dtype=torch.int32, device=dev))
    if positions is None:
        positions = index + torch.arange(s, dtype=torch.int32, device=dev)
        positions = positions[None, :].expand(b, s)
    if cfg.rope == "mrope":
        if mrope_positions is None:
            mrope_positions = positions[None].expand(3, b, s)
        rope = L.rope_sincos(mrope_positions, cfg)
    elif cfg.rope == "none":
        rope = (None, None)
    else:
        rope = L.rope_sincos(positions, cfg)

    encoder_out = None
    if cfg.encoder_layers and encoder_embeds is not None:
        encoder_out = encoder_forward(
            encoder_embeds.to(torch_dtype(cfg.dtype)), params["encoder"], cfg,
            shd)

    width = 0
    cache_layers = None
    attn_index = index
    if cache is not None:
        cache_layers = cache["layers"]
        width = _cache_seq_width(cache_layers)
        if s == 1:
            # per-row index (continuous batching: slots at skewed positions)
            attn_index = positions[:, -1]

    x, new_layers, aux = stack_forward(x, params, cfg, rope, cache_layers,
                                       attn_index, width, encoder_out, shd)

    with span("model.unembed"):
        x = _norm(x, params["final_norm"], cfg, shd)
        # the unembed's vocab over tp, its FSDP dim gathered (kept where
        # the rows do not split: `Shardings.stationary`); a tied embedding
        # keeps its width over tp and contracts it there
        wk = ((None, "tp") if cfg.tie_embeddings
              else ("vocab", shd.stationary(x.shape[0])))
        wv = shd.lay((params["embed"] if cfg.tie_embeddings
                      else params["unembed"]).to(x.dtype), *wk)
        logits = shd.act(L._rows(x, shd, wk[1]) @ wv.t(), "batch", None,
                         "vocab")
        logits = mask_vocab_padding(logits, cfg)

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


def _cache_seq_width(cache_layers) -> int:
    """The self-attention cache's width; 0 when no layer has one (RWKV)."""
    for sl in cache_layers:
        if "k" in sl:
            return sl["k"].shape[2]   # (blocks, B, W, KVH, hd)
    return 0


# --------------------------------------------------------------------- #
# loss
# --------------------------------------------------------------------- #

def lm_loss(logits, labels, aux=0.0, aux_weight: float = 0.01):
    """Mean token cross-entropy in f32 (f64 for an f64 model): the
    logsumexp of each row's logits minus its label's logit, plus
    `aux_weight * aux`. The label logit is gathered; the reference's
    one-hot contraction adds zeros to it, the same value."""
    lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lse = torch.logsumexp(lf, dim=-1)
    if is_dtensor(lf):
        # the reference's vocab-sharded-safe form: the label logit plus
        # exact zeros (a gather across vocab shards has no DTensor rule),
        # the mask cut locally to the logits' layout
        hit = torch.arange(lf.shape[-1], device=lf.device) == \
            labels.long()[..., None]
        hit = hit.redistribute(lf.device_mesh, lf.placements)
        ll = torch.where(hit, lf, torch.zeros((), dtype=lf.dtype,
                                              device=lf.device)).sum(-1)
    else:
        ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - ll).mean() + aux_weight * aux
