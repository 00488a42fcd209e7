"""Transformer building blocks: norms, RoPE and M-RoPE, GQA attention
projections, decode attention over the KV cache, the dense MLP and the
routed MoE layer (capacity dispatch, expert FFN in float or int8, combine,
shared experts).

Counterpart of `repro.models.layers`. Weights are declared as `ParamDef`
with the same shapes: q/k/v weights stay 3-D (d_model, heads, head_dim).
Decode attention goes through `kernels.ops.decode_attention`, the CUDA
kernel on the card and its plain version on the CPU. `flash_attention` is
the reference's chunked pure attention, held to it on the CPU; the model
runs the flash kernel instead. The router and the
expert contractions are plain products outside any kernel, as in the
reference; the int8 contraction is exact (`int8_expert_matmul`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist import replicate_uneven
from ..kernels import ops
from ..kernels._build import LaunchCounter
from ..spans import span
from .config import ModelConfig
from .sharding import NO_SHARDING, ParamDef, Shardings, is_dtensor


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
# RoPE / M-RoPE
# --------------------------------------------------------------------- #

def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    hd = cfg.hd
    return 1.0 / (cfg.rope_theta ** (
        torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd))


def rope_sincos(positions, cfg: ModelConfig):
    """positions: (..., S) int -> sin/cos (..., S, hd/2) f32.

    For M-RoPE (qwen2-vl), positions is (3, B, S): temporal, height and
    width streams. The half head dim is split into sections of hd2//3,
    hd2//3 and the rest, each rotated by its own stream; text tokens
    (t == h == w) reduce to 1-D RoPE."""
    freqs = rope_freqs(cfg, positions.device)
    t = positions.float()[..., None] * freqs
    if cfg.rope == "mrope":                         # t: (3,B,S,hd/2)
        hd2 = freqs.shape[0]
        s1, s2 = hd2 // 3, 2 * (hd2 // 3)
        t = torch.cat([t[0, ..., :s1], t[1, ..., s1:s2], t[2, ..., s2:]],
                      dim=-1)
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


def _proj(x, w, shd: Shardings = NO_SHARDING):
    """x (B,S,d) @ w (d, heads, hd) -> (B,S,heads,hd), one matmul. On a
    mesh, x keeps its batch rows and the product's heads x hd columns are
    split over tp (w's FSDP dim gathered), where the heads divide the tp
    axes or not: a head count that does not (GQA's K/V) would otherwise
    leave every tp device the whole product. An output sharded on its
    last dim over more devices than divide the heads is gathered on that
    mesh dim before the split into heads (DTensor cannot unflatten an
    uneven shard). Where the rows do not split over the batch axes, the
    contraction runs over w's FSDP shard (`Shardings.stationary`)."""
    d, nh, hd = w.shape
    c = shd.stationary(x.shape[0])
    x = _rows(x, shd, c)
    w = shd.lay(w.to(x.dtype).reshape(d, nh * hd), c, "tp")
    y = x @ _grad_as_input(w)
    return _grad_as_input(_heads_whole(y, nh).unflatten(-1, (nh, hd)))


def _rows(x, shd: Shardings, *last: str | None):
    """An activation laid out as a product's left operand: its batch rows
    over the batch axes, its middle dims whole, its last dims by `last`
    (whole where not given)."""
    kinds = ("batch",) + (None,) * (x.dim() - 1 - len(last)) + last
    return shd.lay(x, *kinds)


class _GradAsInput(torch.autograd.Function):
    """Identity on a DTensor whose gradient is redistributed to the
    input's placements: a merged weight view's gradient may come back
    sharded where the heads cannot split evenly, an activation's sharded
    over the sequence where a product's backward cannot take it."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.plc = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.plc:
            g = g.redistribute(ctx.mesh, ctx.plc)
        return g


def _grad_as_input(w):
    if is_dtensor(w) and torch.is_grad_enabled() and w.requires_grad:
        return _GradAsInput.apply(w)
    return w


def _heads_whole(x, heads: int | None = None):
    """`x` with its heads dim (the last dim holding `heads` heads, or dim
    -2) gathered on every mesh dim whose size does not divide the heads:
    DTensor cannot split or merge an uneven shard. A plain tensor as it
    is."""
    if not is_dtensor(x):
        return x
    dim = x.dim() - (1 if heads is not None else 2)
    shape = list(x.shape)
    shape[dim] = heads if heads is not None else shape[dim]
    plc = replicate_uneven(x.placements, shape, x.device_mesh, (dim,))
    if plc != tuple(x.placements):
        x = x.redistribute(x.device_mesh, plc)
    return x


def _qkv(x, p, cfg: ModelConfig, shd: Shardings = NO_SHARDING, *,
         rope_sin=None, rope_cos=None, heads_tp=True):
    """q, k, v of x. heads_tp: q heads over tp (train/prefill); a decode
    step keeps them replicated (flash-decoding: the cache's sequence is
    sharded instead)."""
    q, k, v = (_proj(x, p[n], shd) for n in ("wq", "wk", "wv"))
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.rope != "none" and rope_sin is not None:
        q = apply_rope(q, rope_sin, rope_cos)
        k = apply_rope(k, rope_sin, rope_cos)
    q = shd.act(q, "batch", None, "tp" if heads_tp else None, None)
    k = shd.act(k, "batch", None, None, None)
    v = shd.act(v, "batch", None, None, None)
    return q, k, v


def heads_for_kernel(q, k, v, shd: Shardings = NO_SHARDING):
    """q, k, v laid out for the attention kernel on a mesh: where the tp
    axes span more than one device, K/V are first repeated to all H heads
    (the reference's order: GQA groups do not split over tp), then all
    three are sharded on heads over tp, so each device's q heads meet
    their own K/V heads. A no-op without a mesh or at tp size 1."""
    if shd.mesh is None or shd.tp_size() == 1:
        return q, k, v
    h, kvh = q.shape[2], k.shape[2]
    if kvh != h:
        k = torch.repeat_interleave(k, h // kvh, dim=2)
        v = torch.repeat_interleave(v, h // kvh, dim=2)
    kinds = ("batch", None, "tp", None)
    return shd.act(q, *kinds), shd.act(k, *kinds), shd.act(v, *kinds)


def flash_attention(q, k, v, cfg: ModelConfig, *, causal: bool = True,
                    q_offset: int = 0):
    """Chunked online-softmax attention in plain PyTorch, the counterpart of
    `repro.models.layers.flash_attention`: never holds the (Sq, Skv)
    scores, only (q_chunk, kv_chunk) tiles. q: (B,Sq,H,hd); k, v:
    (B,Skv,KVH,hd), KV repeated to H heads; Sq and Skv multiples of the
    chunks (where they exceed them). Masks: causal, `cfg.sliding_window`,
    query positions from `q_offset`. Running max, sum and output in f32,
    products of the inputs accumulated in f32, P cast to v's dtype as the
    reference's. Nothing on the card's path calls it: the model's
    attention runs the kernels of `kernels.ops`."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qc, kc = min(cfg.q_chunk, sq), min(cfg.kv_chunk, skv)
    if sq % qc or skv % kc:
        raise ValueError(f"flash_attention: Sq {sq} and Skv {skv} must be "
                         f"multiples of the chunks {qc}, {kc}")
    if kvh != h:
        k = torch.repeat_interleave(k, h // kvh, dim=2)
        v = torch.repeat_interleave(v, h // kvh, dim=2)
    acc_t = torch.promote_types(q.dtype, torch.float32)
    window = cfg.sliding_window
    chunks = []
    for q0 in range(0, sq, qc):
        qchunk = q[:, q0:q0 + qc].to(acc_t)
        q_pos = q_offset + q0 + torch.arange(qc, device=q.device)
        m = torch.full((b, h, qc), -1e30, dtype=acc_t, device=q.device)
        l = torch.zeros((b, h, qc), dtype=acc_t, device=q.device)
        acc = torch.zeros((b, h, qc, hd), dtype=acc_t, device=q.device)
        for k0 in range(0, skv, kc):
            vchunk = v[:, k0:k0 + kc]
            k_pos = k0 + torch.arange(kc, device=q.device)
            s = torch.einsum("bqhd,bkhd->bhqk", qchunk,
                             k[:, k0:k0 + kc].to(acc_t)) * scale
            mask = torch.ones((qc, kc), dtype=torch.bool, device=q.device)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window:
                mask &= q_pos[:, None] - k_pos[None, :] < window
            s = torch.where(mask, s, torch.full((), -1e30, dtype=acc_t,
                                                 device=q.device))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vchunk.dtype).to(acc_t),
                vchunk.to(acc_t))
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        chunks.append(o.transpose(1, 2).to(q.dtype))       # (B,qc,H,hd)
    return torch.cat(chunks, dim=1)


def cached_attention(q, k_cache, v_cache, index, cfg: ModelConfig,
                     shd: Shardings = NO_SHARDING):
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


def attn_out(o, p, x_dtype, shd: Shardings = NO_SHARDING):
    """The output projection: on a mesh the heads of o and wo over tp
    (each device's product a partial sum), o's batch rows kept."""
    h, hd, d = p["wo"].shape
    o = _rows(_heads_whole(o), shd, "tp", None)
    wo = shd.lay(p["wo"].to(x_dtype), "tp", None, None)
    out = _grad_as_input(o.flatten(-2)) @ _grad_as_input(
        wo.reshape(h * hd, d))
    # seq-sharded output under SP: the tp-partial sum becomes a
    # reduce-scatter (Megatron sequence parallelism); no-op otherwise
    return shd.act(out, "batch", "seq", None)


# --------------------------------------------------------------------- #
# dense MLP
# --------------------------------------------------------------------- #

def mlp_defs(cfg: ModelConfig, name: str, d_ff: int | None = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
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


def mlp_forward(x, p, cfg: ModelConfig, shd: Shardings = NO_SHARDING):
    """The (gated) MLP; on a mesh each product on the batch rows, its
    weight's ffn dim over tp (the up and gate contractions over their
    FSDP shard where the rows do not split: `Shardings.stationary`)."""
    act = _act_fn(cfg)
    c = shd.stationary(x.shape[0])
    x = _rows(x, shd, c)
    w = {n: shd.lay(p[n].to(x.dtype), *kinds) for n, kinds in
         (("wu", (c, "tp")), ("wg", (c, "tp")), ("wd", ("tp", None)))
         if n in p}
    up = x @ w["wu"]
    if cfg.gated_mlp:
        up = act(x @ w["wg"]) * up
    else:
        up = act(up)
    return shd.act(_rows(up, shd, "tp") @ w["wd"], "batch", "seq", None)


# --------------------------------------------------------------------- #
# MoE (capacity-based dispatch, GShard-style, row-local positions)
# --------------------------------------------------------------------- #

CAPACITY_FACTOR = 1.25
# torch._int_mm on CUDA (cuBLASLt int8 -> int32) takes more than 16 rows
# and K and N multiples of 8; at K = 64 cuBLASLt on the H100 refuses most
# row counts (CUBLAS_STATUS_NOT_SUPPORTED), so a contraction shorter than
# 128 is padded with zeros to 128 (exact)
INT_MM_MIN_ROWS = 17
INT_MM_MULTIPLE = 8
INT_MM_MIN_K = 128


#: the expert contractions on the card: "int8" counts each torch._int_mm
#: call (one per expert and projection), "float" each batched float
#: product over all experts (one per projection); counted on CUDA tensors,
#: never on the CPU path
EXPERT_MM = LaunchCounter()


def moe_defs(cfg: ModelConfig, name: str) -> dict:
    d = cfg.d_model
    e, fe = cfg.n_experts, cfg.moe_d_ff or cfg.d_ff
    defs = {
        "router": ParamDef((d, e), (None, None), f"{name}.router", "small"),
        "wu": ParamDef((e, d, fe), ("experts", "fsdp", "tp"), f"{name}.e_wu"),
        "wd": ParamDef((e, fe, d), ("experts", "tp", "fsdp"), f"{name}.e_wd"),
    }
    if cfg.gated_mlp:
        defs["wg"] = ParamDef((e, d, fe), ("experts", "fsdp", "tp"),
                              f"{name}.e_wg")
    if cfg.n_shared_experts:
        fs = cfg.shared_d_ff or cfg.n_shared_experts * fe
        defs["shared"] = mlp_defs(cfg, f"{name}.shared", fs)
        defs["shared_gate"] = ParamDef((d, 1), (None, None),
                                       f"{name}.shared_gate", "small")
    return defs


def _router_dtype(x):
    """The router's type: f32, as the reference computes it (f64 for an
    f64 model, so that an f64 run is the f64 truth of the whole layer)."""
    return torch.promote_types(x.dtype, torch.float32)


def moe_dispatch(x, router, cfg: ModelConfig, shd: Shardings = NO_SHARDING):
    """Router + top-k gate + capacity scatter. Returns `(buf, topi, pos, w,
    gates)`: the (B, E, C, D) dispatch buffer in x's dtype, each token's
    expert ids, row-local capacity positions (>= C for a dropped token)
    and normalized kept-gate weights (0 where dropped), and the gate
    softmax (for the aux loss). Positions are cumsums within each batch
    row, so a dead serving slot never takes a live row's capacity. Every
    kept (b, e, pos) receives exactly one token and a dropped one adds
    zeros at C - 1, so the accumulating scatter is exact in any order.
    On a mesh everything after the router product runs on each device's
    batch rows (`Shardings.local`): the scatter is row-local."""
    logits = _gate(x, router, shd)
    return shd.local(lambda x, logits: _dispatch_rows(x, logits, cfg),
                     x, logits, n_out=5)


def _gate(x, w, shd: Shardings = NO_SHARDING):
    """x @ w in the router's type (the router, the shared experts' gate):
    on a mesh x keeps its batch rows, and where they do not split the
    contraction runs over "data" (`Shardings.stationary`)."""
    rt = _router_dtype(x)
    c = shd.stationary(x.shape[0])
    return _rows(x, shd, c).to(rt) @ shd.lay(w.to(rt), c, None)


def _dispatch_rows(x, logits, cfg: ModelConfig):
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = max(int(CAPACITY_FACTOR * k * s / e), 1)
    gates = torch.softmax(logits, dim=-1)
    topw, topi = torch.topk(gates, k, dim=-1)              # (B,S,k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # row-local position of each (token, slot) inside its expert
    onehot = F.one_hot(topi, e).to(torch.int32)            # (B,S,k,E)
    pos = torch.cumsum(onehot.reshape(b, s * k, e), dim=1) - 1
    pos = (pos.reshape(b, s, k, e) * onehot).sum(-1)       # (B,S,k)
    keep = pos < cap
    w = topw * keep.to(topw.dtype)

    buf = torch.zeros((b, e, cap, d), dtype=x.dtype, device=x.device)
    bidx = torch.arange(b, device=x.device)[:, None, None].expand(b, s, k)
    src = torch.where(keep[..., None], x[:, :, None, :],
                      torch.zeros((), dtype=x.dtype, device=x.device))
    buf.index_put_((bidx, topi, torch.where(keep, pos, cap - 1)), src,
                   accumulate=True)
    return buf, topi, pos, w, gates


def quantize_q8(w, axis: int = 1):
    """Symmetric per-channel int8 weight quantization: one f32 scale per
    output channel, reduced over the contraction `axis` (kept as a size-1
    dim). The reference's arithmetic step by step (the reciprocal multiply
    `amax * (1/127)`, round half to even), so `(q, scale)` are its bits;
    elementwise ops and a max, so quantizing a stacked tensor once, or
    each layer's slice in the forward, gives the same integers."""
    wf = w.float()
    amax = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), 1.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale


def _quantize_rows(x):
    """Per-row symmetric int8 quantization over the trailing axis;
    returns `(q, scale)` with scale keepdims."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax * (1.0 / 127.0), 1.0)
    q = torch.clamp(torch.round(x / scale), -127, 127)
    return q.to(torch.int8), scale


def int8_expert_matmul(xq, wq):
    """`einsum("becd,edf->becf")` of int8 activations xq (B, E, C, K) and
    int8 weights wq (E, K, N), accumulated in int32: exact, since
    |sum| <= 127^2 K < 2^31 for K < 133144 and integer sums do not depend
    on their order. On the CPU an int32 einsum; on the card one
    `torch._int_mm` (cuBLASLt, int8 in, int32 accumulator) per expert,
    the B*C rows padded with zero rows to its minimum, whose results are
    dropped, and a contraction shorter than INT_MM_MIN_K padded with zero
    columns and rows. Shapes outside `_int_mm`'s limits raise: there is
    no float route for int8 experts."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"int8_expert_matmul: want int8 operands, got "
                         f"{xq.dtype}, {wq.dtype}")
    b, e, c, k = xq.shape
    n = wq.shape[-1]
    if wq.shape != (e, k, n):
        raise ValueError(f"int8_expert_matmul: activations {tuple(xq.shape)}"
                         f" do not match weights {tuple(wq.shape)}")
    if xq.device.type == "cpu":
        return torch.einsum("becd,edf->becf", xq.to(torch.int32),
                            wq.to(torch.int32))
    if k % INT_MM_MULTIPLE or n % INT_MM_MULTIPLE:
        raise ValueError(f"int8_expert_matmul: K = {k} and N = {n} must be "
                         f"multiples of {INT_MM_MULTIPLE} (torch._int_mm)")
    rows = b * c
    m = max(rows, INT_MM_MIN_ROWS)
    xe = xq.permute(1, 0, 2, 3).reshape(e, rows, k)
    if m > rows:
        xe = F.pad(xe, (0, 0, 0, m - rows))
    if k < INT_MM_MIN_K:
        xe = F.pad(xe, (0, INT_MM_MIN_K - k))
        wq = F.pad(wq, (0, 0, 0, INT_MM_MIN_K - k))
    out = torch.empty((e, m, n), dtype=torch.int32, device=xq.device)
    for i in range(e):
        torch._int_mm(xe[i], wq[i], out=out[i])
    EXPERT_MM.count("int8", e)
    return out[:, :rows].reshape(e, b, c, n).permute(1, 0, 2, 3)


def _expert_mm(buf, w):
    """Float `einsum("becd,edf->becf")`: one batched product over E."""
    if buf.is_cuda:
        EXPERT_MM.count("float")
    if is_dtensor(buf):
        # DTensor's einsum views its local operands and, in its backward,
        # the output's gradient; a permuted local layout (from an earlier
        # product) cannot be viewed
        return _ContiguousGrad.apply(torch.einsum(
            "becd,edf->becf", buf.contiguous(), w.to(buf.dtype)))
    return torch.einsum("becd,edf->becf", buf, w.to(buf.dtype))


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def quantize_experts(p) -> dict:
    """`{name: quantize_q8(p[name])}` for the expert weights (E, K, N) of
    one MoE layer's parameter dict."""
    return {n: quantize_q8(p[n]) for n in ("wu", "wg", "wd") if n in p}


def moe_expert_ffn_q8(buf, q8, cfg: ModelConfig,
                      shd: Shardings = NO_SHARDING):
    """`moe_expert_ffn` on int8 expert weights `q8` ({"wu": (q, scale),
    ...}, from `quantize_experts`): int8 x int8 contractions into exact
    int32 accumulators, dequantized in f32 by the row activation scale
    times the per-channel weight scale, the gate nonlinearity in f32, the
    rows re-quantized before the down projection, the result cast back to
    buf's dtype."""
    act = _act_fn(cfg)
    xq, sx = _quantize_rows(buf.float())
    wuq, su = q8["wu"]
    up = int8_expert_matmul(xq, wuq).float() * sx * su[None, :, 0, None, :]
    up = shd.act(up, "batch", None, None, "tp")
    if cfg.gated_mlp:
        wgq, sg = q8["wg"]
        gate = int8_expert_matmul(xq, wgq).float() * sx \
            * sg[None, :, 0, None, :]
        up = shd.act(act(gate), "batch", None, None, "tp") * up
    else:
        up = act(up)
    uq, sup = _quantize_rows(up)
    wdq, sd = q8["wd"]
    out = int8_expert_matmul(uq, wdq).float() * sup * sd[None, :, 0, None, :]
    return shd.act(out.to(buf.dtype), "batch", None, None, None)


def moe_expert_ffn(buf, p, cfg: ModelConfig, shd: Shardings = NO_SHARDING):
    """The per-expert (gated) FFN over the (B, E, C, D) dispatch buffer.
    With `cfg.quant == "int8"` the int8 route: on `p["q8"]` where the
    caller quantized the weights ahead (the serving engine does, once),
    else on weights quantized here; both give the same integers. On a
    mesh the expert products' outputs are held tp-sharded, as the
    reference's; where the rows do not split over the batch axes, the
    weights keep their FSDP shards (`Shardings.stationary`): the up and
    gate products contract over "data", the down product's output is
    split over it."""
    if cfg.quant == "int8":
        q8 = p["q8"] if "q8" in p else quantize_experts(p)
        return moe_expert_ffn_q8(buf, q8, cfg, shd)
    act = _act_fn(cfg)
    c = shd.stationary(buf.shape[0])
    buf = _rows(buf, shd, c)
    w = {n: shd.lay(p[n], *kinds) for n, kinds in
         (("wu", ("experts", c, "tp")), ("wg", ("experts", c, "tp")),
          ("wd", ("experts", "tp", c))) if n in p}
    up = shd.act(_expert_mm(buf, w["wu"]), "batch", None, None, "tp")
    if cfg.gated_mlp:
        gate = shd.act(act(_expert_mm(buf, w["wg"])), "batch", None, None,
                       "tp")
        up = gate * up
    else:
        up = act(up)
    return shd.act(_expert_mm(_rows(up, shd, "tp"), w["wd"]),
                   "batch", None, None, None)


def moe_combine(out_buf, topi, pos, w, dtype, shd: Shardings = NO_SHARDING):
    """Gather each token's expert outputs back from the (B, E, C, D)
    buffer and sum them with the gate weights. A dropped token's position
    (>= C) is clamped to C - 1, as the reference's gather clamps it, and
    its weight is zero. On a mesh the gather runs on each device's batch
    rows."""
    return shd.local(lambda o, t, p, w: _combine_rows(o, t, p, w, dtype),
                     out_buf, topi, pos, w)


def _combine_rows(out_buf, topi, pos, w, dtype):
    b, s, k = topi.shape
    bidx = torch.arange(b, device=out_buf.device)[:, None, None]
    gathered = out_buf[bidx.expand(b, s, k), topi,
                       pos.clamp(max=out_buf.shape[2] - 1)]   # (B,S,k,D)
    return (gathered * w[..., None].to(dtype)).sum(2)


def moe_forward(x, p, cfg: ModelConfig, shd: Shardings = NO_SHARDING):
    """Top-k expert MLP with per-row capacity dispatch: `moe_dispatch`,
    `moe_expert_ffn`, `moe_combine`, plus the shared experts (sigmoid
    gated for qwen2-moe). Returns (y, aux), aux the Switch-style
    load-balance loss in f32. Each part is a span: `model.moe.router`,
    `.aux`, `.experts`, `.combine`, `.shared`."""
    e, k = cfg.n_experts, cfg.top_k
    with span("model.moe.router"):
        buf, topi, pos, w, gates = moe_dispatch(x, p["router"], cfg, shd)

    with span("model.moe.aux"):
        me = gates.float().mean(dim=(0, 1))
        counts = shd.local(lambda t: F.one_hot(t, e).float().sum(2), topi)
        ce = counts.mean(dim=(0, 1)) / k
        aux = e * (me * ce).sum()

    with span("model.moe.experts"):
        out_buf = moe_expert_ffn(buf, p, cfg, shd)
    with span("model.moe.combine"):
        y = moe_combine(out_buf, topi, pos, w, x.dtype, shd)

    if cfg.n_shared_experts:
        with span("model.moe.shared"):
            sh = mlp_forward(x, p["shared"], cfg, shd)
            sg = _grad_as_input(torch.sigmoid(_gate(x, p["shared_gate"],
                                                    shd)))
            y = y + (sh * sg.to(x.dtype) if cfg.name.startswith("qwen2-moe")
                     else sh)
    return shd.act(y, "batch", "seq", None), aux
