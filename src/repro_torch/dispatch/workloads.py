"""Dispatchable workloads: mixed PrIM pipelines, the LM decode chain and
DAGs, the chunked prefill DAGs, and the 16 PrIM workloads as graphs.

The port of `repro.dispatch.workloads`. Two pipeline families exercise
the planner end to end:

  * `mixed_pipeline` — a PrIM-style chain interleaving the paper's two
    workload groups: streaming int phases (VA/SEL/TS/RED patterns — group
    1, PIM-suitable) around a data-reorganization middle (TRNS transpose +
    row rotation — exchange-heavy, the pattern group 2 loses on, KT3).
    Its PIM `trns` stages run `prim.trns.run_pim`, whose bank-local step
    is the transpose kernel.
  * `decode_pipeline` — the serving decode step as a dispatchable chain:
    f32 weight GEMVs, quantized-integer KV-cache attention, rmsnorm glue.

Both builders take `concrete=False` to build shape-only pipelines (storage-
free `meta` tensors): nothing is materialized or executed, but
`Pipeline.graph()` still traces every stage for costing.

The DAG builders (`decode_dag`, `moe_decode_dag`, `decode_steps_dag`,
`prefill_dag`) are what the serving planner consumes; MoE dims route each
layer's MLP through the exchange-phase ladder (router -> token exchange ->
per-expert FFN -> combine exchange), DESIGN.md §12.

Every stage prototype is costed by `graph.node_from_fn`: traced on fake
CPU tensors and counted by `core.census`, never run on the card. On the
CPU the integer attention proxies contract int32 tensors, as the
reference's XLA dots do; the card has no integer matrix product, so there
`_int_einsum` contracts 16-bit halves in f64, which is exact (the census
counts the CPU spelling, the reference's dot).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import types

import numpy as np
import torch
import torch.nn.functional as F

from ..core.bank_parallel import BANKS, BankGrid
from ..core.perf_model import WorkloadCounts
from ..device import resolve_device
from ..models.layers import (CAPACITY_FACTOR as MOE_CAPACITY_FACTOR,
                             moe_combine, moe_dispatch, moe_expert_ffn,
                             moe_expert_ffn_q8)
from ..prim import trns as prim_trns
from .graph import (OpGraph, OpNode, annotate_kv_residency,
                    annotate_kv_write, chain_graph, node_from_fn)
from .runtime import Pipeline, Stage


def _mk(gen, shape, dtype, concrete: bool, device, lo=-100, hi=100):
    if not concrete:
        return torch.empty(shape, dtype=dtype, device="meta")
    if not dtype.is_floating_point:
        return torch.randint(lo, hi, shape, generator=gen, dtype=dtype,
                             device=device)
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) / (shape[-1] ** 0.5)).to(dtype)


def _generator(seed, device, concrete: bool):
    """A torch.Generator seeded with `seed` on the device the arrays are
    drawn on (None when nothing is drawn)."""
    if not concrete:
        return None
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(
        0 if seed is None else int(seed))


# ---------------------------------------------------------------------------
# mixed PrIM pipeline (streaming -> reorganization -> streaming)
# ---------------------------------------------------------------------------

def _pim_roll(grid: BankGrid, x, shift: int):
    """Global row rotation crosses banks: host-mediated gather, then each
    bank takes its block of the rolled matrix (the re-scatter)."""
    full = grid.exchange_gather(x)

    def take(full_b, i):
        rows = full_b.shape[0] // grid.n_banks
        rolled = torch.roll(full_b, shift, dims=0)
        return rolled[i * rows:(i + 1) * rows]

    return grid.local(take, in_specs=(None, BANKS),
                      out_specs=BANKS)(full, grid.bank_ids())


def _relu(v):
    return torch.clamp_min(v, 0)


def _square(v):
    return v * v


def _total(v):
    # int32 sum: modular addition is order-independent, so the bank
    # tree and the host reduction agree exactly
    return torch.sum(v, dtype=v.dtype)


def _add(v, b):
    return v + b


def _transpose(v):
    return v.t()


def _pim_sum(grid: BankGrid, v):
    part = grid.local(lambda vb: torch.sum(vb, dtype=vb.dtype)[None])(v)
    return grid.exchange_reduce(part, op="add")[0]


def _pim_trns(grid: BankGrid, v):
    return prim_trns.run_pim(grid, v.contiguous())


def mixed_pipeline(m: int = 2048, seed=None, concrete: bool = True,
                   device=None) -> Pipeline:
    """Streaming int32 phases around a transpose/rotate/transpose middle,
    on an (m, m) matrix; ends in a RED-style cross-bank sum. `seed` (an
    int or a `torch.Generator`) draws the arrays on `device` (None: the
    card); `concrete=False` draws nothing."""
    dev = resolve_device(device) if concrete else None
    gen = _generator(seed, dev, concrete)
    x = _mk(gen, (m, m), torch.int32, concrete, dev)
    bias = _mk(gen, (m, m), torch.int32, concrete, dev)
    bias2 = _mk(gen, (m, m), torch.int32, concrete, dev)
    shift = m // 3
    nbytes = float(m * m * 4)

    # a transpose is a free view in the census; the cache-blocked host
    # transpose still moves read + write, so charge it explicitly
    stages = [
        Stage("va.add", _add, params=(bias,), local_fn=_add, kind="stream"),
        Stage("va.add2", _add, params=(bias2,), local_fn=_add,
              kind="stream"),
        Stage("sel.relu", _relu, local_fn=_relu, kind="stream"),
        Stage("trns.fwd", _transpose, pim=_pim_trns,
              exchange="all_to_all", exchange_bytes=nbytes,
              hbm_bytes=2 * nbytes, kind="shuffle"),
        Stage("roll.rows", lambda v: torch.roll(v, shift, dims=0),
              pim=functools.partial(_pim_roll, shift=shift),
              exchange="gather", exchange_bytes=nbytes, kind="shuffle"),
        Stage("trns.back", _transpose, pim=_pim_trns,
              exchange="all_to_all", exchange_bytes=nbytes,
              hbm_bytes=2 * nbytes, kind="shuffle"),
        Stage("ts.square", _square, local_fn=_square, kind="stream"),
        Stage("red.sum", _total, pim=_pim_sum,
              exchange="reduce", exchange_bytes=8.0 * 64, kind="reduce"),
    ]
    return Pipeline("prim-mixed", stages, x)


# ---------------------------------------------------------------------------
# LM decode step as a dispatchable chain
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodeDims:
    """Decode-step shape at serving time (KV cache length = seq).

    `n_kv_heads`/`kv_itemsize` size the *resident KV cache* (GQA caches
    fewer heads; real caches may be wider than int32) — they feed the
    migration charge. The modeled attention compute keeps the MHA int32
    proxy regardless (conservative for GQA: it can only overstate PIM's
    attention work, never understate the migration the planner trades it
    against).

    `window` (0 = full attention) is a sliding-window bound: the KV the
    model can ever attend is the last `min(seq, window)` positions, so
    the resident cache is a RING BUFFER of that many rows
    (`models.cache.cache_width`). Attention compute, KV residency, and
    migration charges all price `kv_len` rows, not `seq`, and
    `prefill_dag` drops the cross-chunk KV edges a window makes dead
    (banded prefill)."""
    d_model: int = 4096
    n_heads: int = 32
    head_dim: int = 128
    d_ff: int = 16384
    seq: int = 2048
    vocab: int = 32000
    n_layers: int = 32
    batch: int = 2
    n_kv_heads: int | None = None      # None -> n_heads (MHA)
    kv_itemsize: int = 4
    n_experts: int = 0                 # 0 -> dense MLP layers
    top_k: int = 0
    moe_d_ff: int = 0                  # per-expert ffn width (0 -> d_ff)
    # "" | "int8": int8 expert weights (symmetric per-channel, int32
    # accumulation — models.layers.moe_expert_ffn_q8) and int8 KV storage;
    # pair with kv_itemsize=1 so residency/migration charges shrink 4x
    quant: str = ""
    window: int = 0                    # sliding window (0 = full attention)

    @property
    def kv_heads(self) -> int:
        """Cached KV head count (GQA when n_kv_heads is set, else MHA)."""
        return self.n_kv_heads or self.n_heads

    @property
    def kv_len(self) -> int:
        """Resident KV rows a decode step attends: the ring-buffer width
        `min(seq, window)` under a sliding window, else the full `seq`."""
        return min(self.seq, self.window) if self.window else self.seq

    @property
    def expert_ff(self) -> int:
        """Per-expert FFN width (MoE layers; `moe_d_ff` or `d_ff`)."""
        return self.moe_d_ff or self.d_ff


#: reduced dims for executable runtime tests (same graph structure)
REDUCED_DIMS = DecodeDims(d_model=64, n_heads=4, head_dim=16, d_ff=128,
                          seq=32, vocab=128, n_layers=2, batch=2)

#: reduced MoE dims (mixtral-reduced-shaped: 4 experts top-2)
MOE_REDUCED_DIMS = DecodeDims(d_model=64, n_heads=4, head_dim=16, d_ff=128,
                              seq=32, vocab=128, n_layers=2, batch=2,
                              n_experts=4, top_k=2, moe_d_ff=128)

#: paper-scale MoE dims (mixtral-8x7b-shaped: 8 experts top-2, GQA kv8)
MOE_PAPER_DIMS = DecodeDims(d_model=4096, n_heads=32, head_dim=128,
                            d_ff=14336, seq=2048, vocab=32000, n_layers=32,
                            batch=2, n_kv_heads=8, n_experts=8, top_k=2,
                            moe_d_ff=14336)

#: the KT2-flip configuration: same MoE shapes with int8 expert weights
#: (int32 accumulation) and an int8 KV cache (DESIGN.md §15)
MOE_PAPER_DIMS_INT8 = dataclasses.replace(MOE_PAPER_DIMS, kv_itemsize=1,
                                          quant="int8")
MOE_REDUCED_DIMS_INT8 = dataclasses.replace(MOE_REDUCED_DIMS, kv_itemsize=1,
                                            quant="int8")

#: long-context sliding-window dims (a 4k window over a 32k context)
SWA_PAPER_DIMS = DecodeDims(seq=32768, window=4096)
SWA_REDUCED_DIMS = dataclasses.replace(REDUCED_DIMS, window=8)

#: windowed MoE at the KT2-flip configuration (int8 experts + int8 KV)
MOE_SWA_PAPER_DIMS_INT8 = dataclasses.replace(MOE_PAPER_DIMS_INT8,
                                              seq=32768, window=4096)
MOE_SWA_REDUCED_DIMS_INT8 = dataclasses.replace(MOE_REDUCED_DIMS_INT8,
                                                window=8)

_Q_SCALE = 64.0          # activation quantization step for int attention
_F64_EXACT_K = 2 ** 21   # contraction length whose f64 half sums are exact


def _rmsnorm(x):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)


def _gelu(x):
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default


def _gemv(x, w):
    return x @ w


def _pim_gemv(grid: BankGrid, x, w):
    """Column-partitioned weight-stationary GEMV (the prim MLP layout):
    each bank owns a column block of W; the activation is re-gathered for
    the next stage through the host (KT3's per-layer cost). A column
    block of W is a bank's split of W's columns, so the phase runs on W's
    transpose view and each bank's output block is its columns."""
    def local(xx, wt):
        return (xx @ wt.t()).t()
    return grid.local(local, in_specs=(None, BANKS),
                      out_specs=BANKS)(x, w.t()).t()


def _int_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An int32 einsum with int32 wrap-around, as XLA's int32 dot gives
    it. On the CPU an int32 einsum. On the card, which has no integer
    matrix product: each operand split into a signed high and an unsigned
    low 16-bit half, and the three products that survive mod 2^32
    (lo.lo + 2^16 (hi.lo + lo.hi)) contracted in f64, whose sums of
    products below 2^32 are exact while the contraction is shorter than
    2^21; the pieces recombine in int64 and wrap to int32. Longer
    contractions raise."""
    if a.device.type == "cpu":
        return torch.einsum(eq, a, b)
    ins, out = eq.split("->")
    sa, sb = ins.split(",")
    k = math.prod(a.shape[sa.index(c)] for c in set(sa) & set(sb)
                  if c not in out)
    if k >= _F64_EXACT_K:
        raise ValueError(f"_int_einsum: contraction of {k} terms is past "
                         f"the exact f64 route's {_F64_EXACT_K}")

    def halves(t):
        t = t.long()
        lo = t & 0xFFFF
        return (t - lo) >> 16, lo

    a_hi, a_lo = halves(a)
    b_hi, b_lo = halves(b)

    def dot(x, y):
        return torch.einsum(eq, x.double(), y.double()).long()

    mid = dot(a_hi, b_lo) + dot(a_lo, b_hi)
    total = dot(a_lo, b_lo) + ((mid & 0xFFFF) << 16)
    total = total & 0xFFFFFFFF
    return torch.where(total >= 2 ** 31, total - 2 ** 32, total).to(
        torch.int32)


def _attend(qkv, kq, vq, dims: DecodeDims):
    """Quantized-integer attention over the resident KV cache: int32 dot
    products for scores and AV (DPU-native mul/add), float softmax.

    The batch size comes from the input, not `dims`: under `_pim_attend`
    this body runs on a per-bank shard of `dims.batch / n_banks` rows.
    An int8-stored cache upcasts to the int32 accumulator either way."""
    h, dh = dims.n_heads, dims.head_dim
    kq, vq = kq.to(torch.int32), vq.to(torch.int32)
    b = qkv.shape[0]
    q = qkv.reshape(b, 3, h, dh)[:, 0]
    qq = torch.round(q * _Q_SCALE).to(torch.int32)
    scores_i = _int_einsum("bhd,shd->bhs", qq, kq)
    scores = scores_i.to(torch.float32) / (_Q_SCALE * _Q_SCALE * dh ** 0.5)
    w = torch.softmax(scores, dim=-1)
    wq = torch.round(w * 256.0).to(torch.int32)
    out_i = _int_einsum("bhs,shd->bhd", wq, vq)
    return out_i.to(torch.float32).reshape(b, h * dh) / (256.0 * _Q_SCALE)


def _pim_attend(grid: BankGrid, qkv, kq, vq, dims: DecodeDims):
    """Batch-partitioned attention: each bank holds its sequences' KV
    cache shard (continuous batching across banks) — a pure local
    phase."""
    f = functools.partial(_attend, dims=dims)
    return grid.local(f, in_specs=(BANKS, None, None),
                      out_specs=BANKS)(qkv, kq, vq)


def _embed(t, tab):
    return tab[t]


def _pim_embed(grid, t, tab):
    return grid.local(_embed, in_specs=(BANKS, None), out_specs=BANKS)(t, tab)


def _up(x, w):
    return _gelu(x @ w)


def _pim_up(grid, x, w):
    def local(xx, wt):
        return _gelu(xx @ wt.t()).t()
    return grid.local(local, in_specs=(None, BANKS),
                      out_specs=BANKS)(x, w.t()).t()


def decode_pipeline(dims: DecodeDims = REDUCED_DIMS, seed=None,
                    concrete: bool = True, device=None) -> Pipeline:
    """The serving decode step as a stage chain: rmsnorm -> qkv GEMV ->
    quantized KV attention -> o/up/down GEMVs per layer, then final norm
    and the vocab head. Tokens enter from the host; logits return to the
    host (the `serve.engine` sampling loop)."""
    d = dims
    dev = resolve_device(device) if concrete else None
    gen = _generator(seed, dev, concrete)
    f32, i32 = torch.float32, torch.int32

    def mk(shape, dtype, lo=-100, hi=100):
        return _mk(gen, shape, dtype, concrete, dev, lo, hi)

    tokens = mk((d.batch,), i32, 0, d.vocab)
    table = mk((d.vocab, d.d_model), f32)

    stages = [Stage("embed", _embed, params=(table,), pim=_pim_embed,
                    kind="embed")]
    act_bytes = float(d.batch * d.d_model * 4)
    for i in range(d.n_layers):
        wqkv = mk((d.d_model, 3 * d.n_heads * d.head_dim), f32)
        kq = mk((d.seq, d.n_heads, d.head_dim), i32, -64, 64)
        vq = mk((d.seq, d.n_heads, d.head_dim), i32, -64, 64)
        wo = mk((d.n_heads * d.head_dim, d.d_model), f32)
        wup = mk((d.d_model, d.d_ff), f32)
        wdown = mk((d.d_ff, d.d_model), f32)
        attend = functools.partial(_attend, dims=d)
        stages += [
            Stage(f"ln{i}", _rmsnorm, local_fn=_rmsnorm, kind="norm"),
            Stage(f"qkv{i}", _gemv, params=(wqkv,), pim=_pim_gemv,
                  exchange="gather", exchange_bytes=3 * act_bytes,
                  kind="gemv_qkv"),
            Stage(f"attn{i}", attend, params=(kq, vq),
                  pim=functools.partial(_pim_attend, dims=d), kind="attn"),
            Stage(f"o{i}", _gemv, params=(wo,), pim=_pim_gemv,
                  exchange="gather", exchange_bytes=act_bytes,
                  kind="gemv_o"),
            Stage(f"up{i}", _up, params=(wup,), pim=_pim_up,
                  exchange="gather",
                  exchange_bytes=float(d.batch * d.d_ff * 4),
                  kind="gemv_up"),
            Stage(f"down{i}", _gemv, params=(wdown,), pim=_pim_gemv,
                  exchange="gather", exchange_bytes=act_bytes,
                  kind="gemv_down"),
        ]
    whead = mk((d.d_model, d.vocab), f32)
    stages += [
        Stage("lnf", _rmsnorm, local_fn=_rmsnorm, kind="norm"),
        Stage("head", _gemv, params=(whead,), pim=_pim_gemv,
              exchange="gather", exchange_bytes=float(d.batch * d.vocab * 4),
              kind="gemv_head"),
    ]
    return Pipeline("lm-decode", stages, tokens)


# ---------------------------------------------------------------------------
# MoE routing as an exchange phase (router -> dispatch -> experts -> combine)
# ---------------------------------------------------------------------------

#: GShard-style token capacity headroom — the executable MoE layer's, so
#: the planner's buffer shapes and exchange volumes cannot drift from
#: what `serve.dispatch_engine` runs
_MOE_CAPACITY_FACTOR = MOE_CAPACITY_FACTOR


def moe_capacity(tokens_per_seq: int, n_experts: int, top_k: int) -> int:
    """Per-expert token capacity of one sequence row — the
    `models.layers.CAPACITY_FACTOR` semantics the serving stages share:
    `max(int(cf * k * s / e), 1)`."""
    return max(int(_MOE_CAPACITY_FACTOR * top_k * tokens_per_seq
                   / n_experts), 1)


def moe_exchange_bytes(tokens: int, d_model: int, top_k: int,
                       itemsize: int = 4) -> float:
    """Bytes one MoE token exchange re-distributes across banks (each of
    the dispatch and the combine moves this much): every token's `top_k`
    dispatched copies at capacity-factor headroom. The volume scales with
    tokens x capacity, NOT with the expert count — empty capacity slots
    never travel."""
    return float(_MOE_CAPACITY_FACTOR * top_k * tokens * d_model * itemsize)


def _moe_cfg(**kw):
    return types.SimpleNamespace(gated_mlp=True, mlp_act="silu", quant="",
                                 **kw)


def _moe_router(x, wr, *, seq: int, top_k: int):
    """Costing proxy for the MoE router + top-k gate + dispatch scatter:
    `models.layers.moe_dispatch` itself (the slice the serving stages
    execute) on (rows, d) flattened tokens, `seq` tokens per sequence
    row."""
    n, d = x.shape
    b = n // seq
    cfg = _moe_cfg(n_experts=wr.shape[1], top_k=top_k)
    buf, topi, pos, w, _ = moe_dispatch(x.reshape(b, seq, d), wr, cfg)
    return buf, topi, pos, w


def _moe_expert(buf, wu, wg, wd):
    """Costing proxy for the per-expert gated FFN over the dispatched
    (B, E, C, D) buffer: `models.layers.moe_expert_ffn` itself."""
    return moe_expert_ffn(buf, {"wu": wu, "wg": wg, "wd": wd}, _moe_cfg())


def _moe_expert_q8(buf, wuq, su, wgq, sg, wdq, sd):
    """Costing proxy for the QUANTIZED per-expert FFN on PRE-quantized
    int8 weights (4x smaller weight bytes, int8 x int8 contractions into
    int32): `models.layers.moe_expert_ffn_q8` itself (DESIGN.md §15)."""
    q8 = {"wu": (wuq, su), "wg": (wgq, sg), "wd": (wdq, sd)}
    return moe_expert_ffn_q8(buf, q8, _moe_cfg())


def _moe_combine(x, out_buf, topi, pos, w, *, seq: int):
    """Costing proxy for the combine: gather each token's expert outputs
    back from the (B, E, C, D) buffer, weight by the gates, and add into
    the residual stream."""
    n, d = x.shape
    y = moe_combine(out_buf, topi, pos, w, x.dtype)
    return x + y.reshape(n, d)


# ---------------------------------------------------------------------------
# LM decode step as a DAG (residual branches + attention fan-out)
# ---------------------------------------------------------------------------

def _S(shape, dtype):
    """A storage-free example tensor for a stage prototype."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _f_qkv(v, w):
    return _rmsnorm(v) @ w


def _f_o(a, res, w):
    return res + a @ w


def _f_mlp(v, wu, wd):
    return v + _gelu(_rmsnorm(v) @ wu) @ wd


def _f_head(v, w):
    return _rmsnorm(v) @ w


def _decode_protos(d: DecodeDims, expert_shards: int = 1) -> dict:
    """Trace each distinct decode-stage shape once — later layers (and
    later steps of `decode_steps_dag`) are renamed copies. With
    `expert_shards=R > 1` the expert proto is ONE shard's FFN over
    `n_experts / R` experts, and the router's `out_bytes` shrink to one
    shard's slice."""
    f32, i32 = torch.float32, torch.int32
    q8 = d.quant == "int8"
    kv_dt = torch.int8 if q8 else i32
    S = _S
    dm, hdh = d.d_model, d.n_heads * d.head_dim
    act_bytes = float(d.batch * dm * 4)

    tokens = S((d.batch,), i32)
    table = S((d.vocab, dm), f32)
    x = S((d.batch, dm), f32)
    qkv_out = S((d.batch, 3 * hdh), f32)
    attn_out = S((d.batch, hdh), f32)
    wqkv = S((dm, 3 * hdh), f32)
    # a sliding window bounds the attended KV to the ring width
    kq = S((d.kv_len, d.n_heads, d.head_dim), kv_dt)
    vq = S((d.kv_len, d.n_heads, d.head_dim), kv_dt)
    wo = S((hdh, dm), f32)
    wup, wdown = S((dm, d.d_ff), f32), S((d.d_ff, dm), f32)
    whead = S((dm, d.vocab), f32)

    attend = functools.partial(_attend, dims=d)
    protos = {
        "embed": node_from_fn("embed", _embed, tokens, table, kind="embed"),
        "qkv": node_from_fn("qkv", _f_qkv, x, wqkv, kind="gemv_qkv",
                            exchange_bytes=3 * act_bytes),
        "attn": node_from_fn("attn", attend, qkv_out, kq, vq, kind="attn"),
        "o": node_from_fn("o", _f_o, attn_out, x, wo, kind="gemv_o",
                          exchange_bytes=act_bytes),
    }
    if d.n_experts > 0:
        e, k, fe = d.n_experts, d.top_k, d.expert_ff
        es = e // expert_shards        # experts one shard holds
        cap = moe_capacity(1, e, k)    # decode: 1 token per slot row
        wr = S((dm, e), f32)
        buf = S((d.batch, e, cap, dm), f32)
        buf_shard = S((d.batch, es, cap, dm), f32)
        topi = S((d.batch, 1, k), torch.int64)
        pos_ = S((d.batch, 1, k), torch.int64)
        gate_w = S((d.batch, 1, k), f32)
        router_fn = functools.partial(_moe_router, seq=1, top_k=k)
        combine_fn = functools.partial(_moe_combine, seq=1)
        if q8:      # pre-quantized int8 weights + per-channel f32 scales
            i8 = torch.int8
            expert_proto = node_from_fn(
                "expert", _moe_expert_q8, buf_shard, S((es, dm, fe), i8),
                S((es, 1, fe), f32), S((es, dm, fe), i8),
                S((es, 1, fe), f32), S((es, fe, dm), i8),
                S((es, 1, dm), f32), kind="moe_expert")
        else:
            expert_proto = node_from_fn(
                "expert", _moe_expert, buf_shard, S((es, dm, fe), f32),
                S((es, dm, fe), f32), S((es, fe, dm), f32),
                kind="moe_expert")
        router_proto = node_from_fn("router", router_fn, x, wr,
                                    kind="moe_router")
        if expert_shards > 1:
            # each shard's stage-in pulls only its slice of the dispatch
            # buffer: R rank crossings move the original total volume
            router_proto = dataclasses.replace(
                router_proto, out_bytes=router_proto.out_bytes
                / expert_shards)
        protos.update({
            "router": router_proto,
            "expert": expert_proto,
            # the combine's compute is over the FULL reassembled buffer
            "combine": node_from_fn("combine", combine_fn, x, buf, topi,
                                    pos_, gate_w, kind="moe_combine"),
        })
    else:
        protos["mlp"] = node_from_fn(
            "mlp", _f_mlp, x, wup, wdown, kind="mlp",
            exchange_bytes=float(d.batch * d.d_ff * 4) + act_bytes)
    protos["head"] = node_from_fn(
        "head", _f_head, x, whead, kind="gemv_head",
        exchange_bytes=float(d.batch * d.vocab * 4))
    return protos


def _check_decode_dims(d: DecodeDims, expert_shards: int) -> None:
    if expert_shards < 1:
        raise ValueError(f"need expert_shards >= 1, got {expert_shards}")
    if expert_shards > 1:
        if d.n_experts <= 0:
            raise ValueError("expert_shards > 1 needs MoE dims "
                             f"(n_experts > 0), got {d}")
        if d.n_experts % expert_shards:
            raise ValueError(f"n_experts={d.n_experts} not divisible by "
                             f"expert_shards={expert_shards}")


def _copy_node(proto: OpNode, name: str) -> OpNode:
    return dataclasses.replace(proto, name=name, ops=dict(proto.ops),
                               meta=dict(proto.meta))


def _add_decode_step(g: OpGraph, d: DecodeDims, protos: dict, *,
                     kv_home: str | None, expert_shards: int = 1,
                     sfx: str = "", prev_attns: list[str] | None = None,
                     prev_head: str | None = None) -> tuple[str, list[str]]:
    """Add one decode step's node ladder to `g`, every name suffixed
    `sfx` (`decode_steps_dag`'s `"/s{k}"`; empty for `decode_dag`).
    `prev_attns` adds the per-layer KV-order edges from the previous
    step's attention; `prev_head` the sampled-token edge. Returns (head
    name, attention names) for the next step's wiring."""
    moe = d.n_experts > 0
    R = expert_shards
    # migrating a layer's cache off-home moves every slot's K and V rows
    # at the cache's real width (GQA heads, real itemsize, ring rows)
    kv_bytes = 2.0 * d.batch * d.kv_len * d.kv_heads * d.head_dim \
        * d.kv_itemsize
    xbytes = moe_exchange_bytes(d.batch, d.d_model, d.top_k) if moe else 0.0

    def layer_node(kind, name):
        return _copy_node(protos[kind], name)

    embed_preds = (prev_head,) if prev_head else ()
    g.add(layer_node("embed", f"embed{sfx}"), *embed_preds)
    res = f"embed{sfx}"                # the residual stream's producer
    attns: list[str] = []
    for i in range(d.n_layers):
        g.add(layer_node("qkv", f"qkv{i}{sfx}"), res)
        attn_preds = [f"qkv{i}{sfx}"]
        if prev_attns is not None:     # KV order across decode steps
            attn_preds.append(prev_attns[i])
        attn = g.add(layer_node("attn", f"attn{i}{sfx}"), *attn_preds)
        attns.append(attn.name)
        if kv_home is not None:
            annotate_kv_residency(attn, kv_bytes, kv_home)
        g.add(layer_node("o", f"o{i}{sfx}"), f"attn{i}{sfx}", res)
        if moe:
            g.add(layer_node("router", f"router{i}{sfx}"), f"o{i}{sfx}")
            # the token exchanges: dispatch buffer out, expert outputs
            # back; R shards split the same total volume R ways
            if R == 1:
                g.add(layer_node("expert", f"expert{i}{sfx}"),
                      f"router{i}{sfx}")
                g.add(layer_node("combine", f"combine{i}{sfx}"),
                      f"expert{i}{sfx}", f"router{i}{sfx}", f"o{i}{sfx}")
                g.annotate_exchange(f"router{i}{sfx}", f"expert{i}{sfx}",
                                    xbytes)
                g.annotate_exchange(f"expert{i}{sfx}", f"combine{i}{sfx}",
                                    xbytes)
            else:
                shards = [f"expert{i}@r{j}{sfx}" for j in range(R)]
                for sn in shards:
                    g.add(layer_node("expert", sn), f"router{i}{sfx}")
                    g.annotate_exchange(f"router{i}{sfx}", sn, xbytes / R)
                g.add(layer_node("combine", f"combine{i}{sfx}"),
                      *shards, f"router{i}{sfx}", f"o{i}{sfx}")
                for sn in shards:
                    g.annotate_exchange(sn, f"combine{i}{sfx}", xbytes / R)
            res = f"combine{i}{sfx}"
        else:
            g.add(layer_node("mlp", f"mlp{i}{sfx}"), f"o{i}{sfx}")
            res = f"mlp{i}{sfx}"
    head = g.add(layer_node("head", f"head{sfx}"), res)
    return head.name, attns


def _decode_dag_name(d: DecodeDims, expert_shards: int) -> str:
    base = "lm-moe-decode-dag" if d.n_experts > 0 else "lm-decode-dag"
    return base + ("-int8" if d.quant == "int8" else "") \
        + (f"-swa{d.window}" if 0 < d.window < d.seq else "") \
        + (f"-ep{expert_shards}" if expert_shards > 1 else "")


def decode_dag(dims: DecodeDims = REDUCED_DIMS, *,
               kv_home: str | None = "upmem_2556",
               expert_shards: int = 1) -> OpGraph:
    """The full decode-step DAG the serving planner consumes.

    Unlike `decode_pipeline`, this keeps the real dataflow: each layer's
    residual stream fans out to both the qkv projection and the post-
    attention add (series-parallel, frontier width 2 — the frontier DP's
    exact class). Node names match the executable stages of
    `serve.dispatch_engine` ("embed", "qkv{i}", "attn{i}", "o{i}",
    "mlp{i}", "head"), so a plan over this graph routes that engine
    directly.

    `kv_home` annotates every attention node with its layer's KV-cache
    residency (`graph.annotate_kv_residency`); None disables residency.

    MoE dims (`dims.n_experts > 0`) replace each layer's dense `mlp{i}`
    with the routed ladder `router{i}` -> `expert{i}` -> `combine{i}`,
    the router->expert and expert->combine edges annotated as token
    EXCHANGES (`OpGraph.annotate_exchange`, volume `moe_exchange_bytes`).
    `expert_shards=R > 1` splits each layer's expert FFN into R shard
    nodes `expert{i}@r{j}` over `n_experts / R` experts each, with the
    exchange volume split R ways (`expert_parallel_plan`)."""
    d = dims
    _check_decode_dims(d, expert_shards)
    protos = _decode_protos(d, expert_shards)
    g = OpGraph(_decode_dag_name(d, expert_shards),
                input_bytes=float(d.batch * 4))
    _add_decode_step(g, d, protos, kv_home=kv_home,
                     expert_shards=expert_shards)
    return g


def moe_decode_dag(dims: DecodeDims = MOE_REDUCED_DIMS, *,
                   kv_home: str | None = "upmem_2556",
                   expert_shards: int = 1) -> OpGraph:
    """The MoE decode-step DAG (`decode_dag` with routed expert layers).
    Requires MoE dims (`dims.n_experts > 0`)."""
    if dims.n_experts <= 0 or dims.top_k <= 0:
        raise ValueError("moe_decode_dag needs MoE dims "
                         f"(n_experts/top_k), got {dims}")
    return decode_dag(dims, kv_home=kv_home, expert_shards=expert_shards)


def decode_steps_dag(dims: DecodeDims = REDUCED_DIMS, *, n_steps: int = 2,
                     kv_home: str | None = "upmem_2556",
                     sampled: bool = False,
                     expert_shards: int = 1) -> OpGraph:
    """`n_steps` consecutive decode steps unrolled into ONE plannable DAG
    (cross-step pipelining), step k's nodes suffixed `"/s{k}"`
    (`stage_step`). `sampled=False` is the scoring / speculative-
    verification contract (every step's input token known up front: the
    only cross-step edges are the per-layer KV-order edges);
    `sampled=True` adds `head/s{k}` -> `embed/s{k+1}`, the greedy-decode
    contract."""
    d = dims
    if n_steps < 1:
        raise ValueError(f"need n_steps >= 1, got {n_steps}")
    _check_decode_dims(d, expert_shards)
    protos = _decode_protos(d, expert_shards)
    name = _decode_dag_name(d, expert_shards) + f"-steps{n_steps}" \
        + ("-sampled" if sampled else "")
    g = OpGraph(name, input_bytes=float(d.batch * 4) * n_steps)
    prev_attns: list[str] | None = None
    prev_head: str | None = None
    for s in range(n_steps):
        head, attns = _add_decode_step(
            g, d, protos, kv_home=kv_home, expert_shards=expert_shards,
            sfx=f"/s{s}", prev_attns=prev_attns,
            prev_head=prev_head if sampled else None)
        prev_attns, prev_head = attns, head
    return g


def expert_parallel_plan(graph: OpGraph, topology, *, source: str = "xeon",
                         sink: str = "xeon",
                         objective: str = "overlapped"):
    """Construct the expert-parallel plan of an `expert_shards`-sharded
    decode DAG under a multi-rank `placement.Topology`: plan the single-
    rank placement as usual, then rotate each PIM-placed expert shard j
    (`stage_shard`) onto rank `j % n_ranks`. Returns an `evaluate`d Plan
    (method `"expert-parallel"`); shards the base plan kept on the host
    stay there."""
    from .placement import _is_pim, evaluate
    from .placement import plan as plan_placement
    base = plan_placement(graph, devices=(source, topology.base),
                          source=source, sink=sink, objective=objective)
    assignment = dict(base.assignment)
    for n in assignment:
        j = stage_shard(n)
        if j is not None and _is_pim(assignment[n]):
            assignment[n] = topology.rank_device(j % topology.n_ranks)
    return evaluate(graph, assignment, topology.dpu, source, sink,
                    method="expert-parallel")


# ---------------------------------------------------------------------------
# chunked LM prefill as a DAG (per-chunk fan-out, KV write residency)
# ---------------------------------------------------------------------------

def _attend_prefill(qkv, kq, vq, dims: DecodeDims, t: int, q0: int,
                    k0: int = 0, window: int = 0):
    """Costing proxy for one prefill chunk's attention: `t` query rows at
    positions q0..q0+t-1 attend causally over the keys written so far,
    with the decode `_attend`'s quantized-int dot / float-softmax mix.
    Under a sliding `window` the key tensor starts at absolute position
    `k0` (the first live chunk's offset) and the mask adds
    `q_pos - k_pos < window`.

    The mask depends on shapes alone, so XLA folds it into a constant in
    the reference; here it is built outside the traced arithmetic from
    Python ranges and enters as a constant too."""
    h, dh = dims.n_heads, dims.head_dim
    kq, vq = kq.to(torch.int32), vq.to(torch.int32)
    b = qkv.shape[0] // t
    q = qkv.reshape(b, t, 3, h, dh)[:, :, 0]
    qq = torch.round(q * _Q_SCALE).to(torch.int32)
    scores_i = _int_einsum("bthd,shd->bhts", qq, kq)
    scores = scores_i.to(torch.float32) / (_Q_SCALE * _Q_SCALE * dh ** 0.5)
    mask = _prefill_mask(t, kq.shape[0], q0, k0, window, scores.device)
    scores = torch.where(mask, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    wq = torch.round(w * 256.0).to(torch.int32)
    out_i = _int_einsum("bhts,shd->bthd", wq, vq)
    return (out_i.to(torch.float32).reshape(b * t, h * dh)
            / (256.0 * _Q_SCALE))


def _prefill_mask(t: int, s: int, q0: int, k0: int, window: int, device):
    """The (t, s) causal (and window) mask of `_attend_prefill`, made on
    the host and lifted in as a constant."""
    q_pos = np.arange(q0, q0 + t)[:, None]
    k_pos = np.arange(k0, k0 + s)[None, :]
    mask = q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    return torch.tensor(mask, device=device)


@functools.lru_cache(maxsize=1 << 14)
def parse_stage_name(name: str) -> tuple[str, int | None, int | None]:
    """Split a planner/executor stage name into (kind, layer, chunk).

    The routing contract between DAG builders and the serving steps:
    decode names are `"{kind}{layer}"` (`"qkv3"` -> `("qkv", 3, None)`),
    prefill names append the chunk (`"attn2/c1"` -> `("attn", 2, 1)`),
    and the unnumbered stages parse as `("embed", None, ...)` /
    `("head", None, None)`. The grammar is
    `"{kind}{layer}[@r{shard}][/c{chunk}][/s{step}]"`: the shard and step
    suffixes are stripped here (`stage_shard`, `stage_step` recover
    them)."""
    base, _, _s = name.partition("/s")
    base, _, c = base.partition("/c")
    base, _, _r = base.partition("@r")
    kind = base.rstrip("0123456789")
    layer = int(base[len(kind):]) if len(base) > len(kind) else None
    return kind, layer, (int(c) if c else None)


def stage_shard(name: str) -> int | None:
    """The expert-parallel shard index of a stage name (`"expert1@r2"` ->
    2; None for unsharded stages)."""
    base, _, _s = name.partition("/s")
    base, _, _c = base.partition("/c")
    _, _, r = base.partition("@r")
    return int(r) if r else None


def stage_step(name: str) -> int | None:
    """The cross-step index of a `decode_steps_dag` stage name
    (`"qkv3/s1"` -> 1; None outside step-unrolled DAGs)."""
    _, _, s = name.partition("/s")
    return int(s) if s else None


def stage_kind(name: str) -> str:
    """The stage *kind* of a planner/executor node name (`"qkv3/c1"` ->
    `"qkv"`) — the key into the executor's per-kind stage library."""
    return parse_stage_name(name)[0]


def prefill_serial_order(graph: OpGraph) -> list[str]:
    """The chunk-major linearization of a prefill DAG's nodes — chunk 0's
    full ladder, then chunk 1's, ... (un-chunked nodes like the head
    last): a stable sort of its topological order by chunk index, so a
    valid topological order."""
    order = graph.topo_order()
    pos = {n: i for i, n in enumerate(order)}

    def key(name):
        chunk = parse_stage_name(name)[2]
        return (chunk if chunk is not None else len(order), pos[name])
    return sorted(order, key=key)


def prefill_chunk_splits(s_len: int, chunk: int) -> list[int]:
    """Chunk lengths a `s_len`-token prompt is processed in: full `chunk`
    slices plus a possibly ragged tail. The single source of truth for
    both the prefill DAG's chunk grid and the executable chunking in
    `serve.dispatch_engine.DispatchPrefillStep`."""
    if chunk < 1 or s_len < 1:
        raise ValueError(f"need chunk >= 1 and s_len >= 1, got "
                         f"chunk={chunk}, s_len={s_len}")
    splits = [chunk] * (s_len // chunk)
    if s_len % chunk:
        splits.append(s_len % chunk)
    return splits


def prefill_live_from(splits, window: int) -> list[int]:
    """Per-chunk banding bound for windowed prefill: `live_from[c]` is
    the FIRST chunk index whose KV chunk `c`'s queries can still attend
    under a sliding `window` (the `q_pos - k_pos < window` bound). All
    zeros when `window == 0`. The single source of truth for the banded
    prefill DAG's dropped edges AND the executable banded KV prefix in
    `serve.dispatch_engine.DispatchPrefillStep`."""
    offs = [0]
    for t in splits:
        offs.append(offs[-1] + int(t))
    if not window:
        return [0] * len(splits)
    live = []
    for c in range(len(splits)):
        j = c
        while j > 0 and offs[j] - 1 >= offs[c] - window + 1:
            j -= 1
        live.append(j)
    return live


def prefill_dag(dims: DecodeDims = REDUCED_DIMS, *,
                prefill_len: int | None = None, chunk: int | None = None,
                batch: int = 1, kv_home: str | None = "upmem_2556",
                costed: bool = True) -> OpGraph:
    """Chunked prefill as the operator DAG the serving planner consumes.

    The prompt (`prefill_len` tokens, default `dims.seq`) is split into
    ceil(prefill_len/chunk) chunks (default 4 chunks; the last may be
    ragged). Each chunk runs the decode DAG's per-layer ladder, and every
    chunk's qkv output also fans out to all later chunks' attention at the
    same layer (the freshly written KV rows they read). Only the last
    chunk feeds the vocab head.

    KV residency (`kv_home`; None disables): attention of chunk c READS
    the prior chunks' rows resident at `kv_home` and WRITES its own.
    Node names follow `"{stage}{layer}/c{chunk}"`, the routing contract
    `serve.dispatch_engine.DispatchPrefillStep` executes.

    Sliding-window dims (`0 < dims.window < prefill_len`) build the
    BANDED variant: chunk c fans in KV only from live chunks
    (`prefill_live_from`); the graph name gains `-swa{window}`.

    MoE dims give every chunk's layer the routed ladder instead of
    `mlp`, with capacity per chunk (`moe_capacity(t, ...)`).

    `costed=False` builds the same node names / edges / insertion order
    with zero-cost nodes and no tracing — the structural skeleton
    `dispatch.executor.PlanExecutor` groups a prompt's execution timeline
    from (exchange-edge annotations and `meta["kv_writers"]` kept)."""
    d = dims
    S_len = prefill_len if prefill_len is not None else d.seq
    c_len = chunk if chunk is not None else max(1, -(-S_len // 4))
    splits = prefill_chunk_splits(S_len, c_len)
    win = d.window if 0 < d.window < S_len else 0
    live_from = prefill_live_from(splits, win)
    offs = [0]
    for t in splits:
        offs.append(offs[-1] + t)

    f32, i32 = torch.float32, torch.int32
    q8 = d.quant == "int8"
    kv_dt = torch.int8 if q8 else i32
    S = _S
    dm, hdh = d.d_model, d.n_heads * d.head_dim
    kv_row_bytes = 2.0 * batch * d.kv_heads * d.head_dim * d.kv_itemsize

    wqkv = S((dm, 3 * hdh), f32)
    wo = S((hdh, dm), f32)
    wup, wdown = S((dm, d.d_ff), f32), S((d.d_ff, dm), f32)
    whead = S((dm, d.vocab), f32)
    table = S((d.vocab, dm), f32)

    # trace each distinct stage shape once; same-shape chunks share it
    protos: dict[tuple, OpNode] = {}

    def proto(kind, key, build):
        if not costed:                 # structural skeleton: names/edges
            key = "struct"
        if (kind, key) not in protos:
            protos[(kind, key)] = build() if costed else OpNode(
                name=kind, kind=kind, flops=0.0, hbm_bytes=0.0,
                out_bytes=0.0)
        return protos[(kind, key)]

    base_name = "lm-moe-prefill-dag" if d.n_experts else "lm-prefill-dag"
    g = OpGraph(base_name + ("-int8" if q8 else "")
                + (f"-swa{win}" if win else ""),
                input_bytes=float(batch * S_len * 4))
    res: list[str | None] = [None] * len(splits)  # chunk residual producers
    for c, t in enumerate(splits):
        tokens = S((batch * t,), i32)
        node = proto("embed", t, lambda: node_from_fn(
            "embed", _embed, tokens, table, kind="embed"))
        g.add(_copy_node(node, f"embed/c{c}"))
        res[c] = f"embed/c{c}"
    for i in range(d.n_layers):
        qkv_names: list[str] = []
        c0 = 0
        for c, t in enumerate(splits):
            rows = batch * t
            k0 = offs[live_from[c]]    # banding: keys start at live chunk
            prefix = c0 + t - k0
            x = S((rows, dm), f32)
            qkv_out = S((rows, 3 * hdh), f32)
            attn_out = S((rows, hdh), f32)
            kq = S((prefix, d.n_heads, d.head_dim), kv_dt)
            vq = S((prefix, d.n_heads, d.head_dim), kv_dt)
            act_bytes = float(rows * dm * 4)

            node = proto("qkv", t, lambda: node_from_fn(
                "qkv", _f_qkv, x, wqkv, kind="gemv_qkv",
                exchange_bytes=3 * act_bytes))
            qkv = g.add(_copy_node(node, f"qkv{i}/c{c}"), res[c])
            qkv_names.append(qkv.name)

            attend = functools.partial(_attend_prefill, dims=d, t=t,
                                       q0=c0, k0=k0, window=win)
            node = proto("attn", (t, prefix), lambda: node_from_fn(
                "attn", attend, qkv_out, kq, vq, kind="attn"))
            # fan-in: this chunk's qkv plus every LIVE earlier chunk's
            attn = g.add(_copy_node(node, f"attn{i}/c{c}"),
                         *qkv_names[live_from[c]:])
            if kv_home is not None:
                if c0 - k0:
                    annotate_kv_residency(attn, kv_row_bytes * (c0 - k0),
                                          kv_home)
                    attn.meta["kv_writers"] = [f"attn{i}/c{j}"
                                               for j in range(live_from[c],
                                                              c)]
                # the ring keeps at most `win` of this chunk's rows
                annotate_kv_write(attn, kv_row_bytes * (min(t, win) if win
                                                        else t), kv_home)

            node = proto("o", t, lambda: node_from_fn(
                "o", _f_o, attn_out, x, wo, kind="gemv_o",
                exchange_bytes=act_bytes))
            g.add(_copy_node(node, f"o{i}/c{c}"), f"attn{i}/c{c}", res[c])
            if d.n_experts:            # routed MoE ladder for this chunk
                e, k = d.n_experts, d.top_k
                cap = moe_capacity(t, e, k)
                fe = d.expert_ff
                buf = S((batch, e, cap, dm), f32)
                topi = S((batch, t, k), torch.int64)
                pos_ = S((batch, t, k), torch.int64)
                gate_w = S((batch, t, k), f32)
                r_fn = functools.partial(_moe_router, seq=t, top_k=k)
                c_fn = functools.partial(_moe_combine, seq=t)
                node = proto("router", t, lambda: node_from_fn(
                    "router", r_fn, x, S((dm, e), f32), kind="moe_router"))
                g.add(_copy_node(node, f"router{i}/c{c}"), f"o{i}/c{c}")
                if q8:
                    i8 = torch.int8
                    node = proto("expert", t, lambda: node_from_fn(
                        "expert", _moe_expert_q8, buf, S((e, dm, fe), i8),
                        S((e, 1, fe), f32), S((e, dm, fe), i8),
                        S((e, 1, fe), f32), S((e, fe, dm), i8),
                        S((e, 1, dm), f32), kind="moe_expert"))
                else:
                    node = proto("expert", t, lambda: node_from_fn(
                        "expert", _moe_expert, buf, S((e, dm, fe), f32),
                        S((e, dm, fe), f32), S((e, fe, dm), f32),
                        kind="moe_expert"))
                g.add(_copy_node(node, f"expert{i}/c{c}"), f"router{i}/c{c}")
                node = proto("combine", t, lambda: node_from_fn(
                    "combine", c_fn, x, buf, topi, pos_, gate_w,
                    kind="moe_combine"))
                g.add(_copy_node(node, f"combine{i}/c{c}"),
                      f"expert{i}/c{c}", f"router{i}/c{c}", f"o{i}/c{c}")
                xbytes = moe_exchange_bytes(rows, dm, k)
                g.annotate_exchange(f"router{i}/c{c}", f"expert{i}/c{c}",
                                    xbytes)
                g.annotate_exchange(f"expert{i}/c{c}", f"combine{i}/c{c}",
                                    xbytes)
                res[c] = f"combine{i}/c{c}"
            else:
                node = proto("mlp", t, lambda: node_from_fn(
                    "mlp", _f_mlp, x, wup, wdown, kind="mlp",
                    exchange_bytes=float(rows * d.d_ff * 4) + act_bytes))
                g.add(_copy_node(node, f"mlp{i}/c{c}"), f"o{i}/c{c}")
                res[c] = f"mlp{i}/c{c}"
            c0 += t
    t_last = splits[-1]
    x_last = S((batch * t_last, dm), f32)
    head = (node_from_fn("head", _f_head, x_last, whead, kind="gemv_head",
                         exchange_bytes=float(batch * t_last * d.vocab * 4))
            if costed else OpNode(name="head", kind="gemv_head", flops=0.0,
                                  hbm_bytes=0.0, out_bytes=0.0))
    g.add(head, res[-1])
    return g


# ---------------------------------------------------------------------------
# the 16 PrIM workloads as one-operator graphs
# ---------------------------------------------------------------------------

def node_from_counts(c: WorkloadCounts) -> OpNode:
    """Lift a PrIM workload's analytic counts into a single OpNode (the
    whole workload is one operator — Fig. 4's granularity)."""
    return OpNode(name=c.name, kind="prim", flops=c.flops_equiv,
                  hbm_bytes=c.bytes_streamed, out_bytes=0.0,
                  ops=dict(c.ops), exchange_bytes=c.interbank_bytes,
                  meta={"pim_suitable": c.pim_suitable,
                        "bytes_cpu": c.bytes_cpu, "bytes_gpu": c.bytes_gpu})


def prim_graph(c: WorkloadCounts) -> OpGraph:
    """A PrIM workload as a one-node OpGraph (the planner's unit case)."""
    return chain_graph(c.name, [node_from_counts(c)])


# ---------------------------------------------------------------------------
# the shipped-graph registry
# ---------------------------------------------------------------------------

#: planner device sets the shipped goldens were pinned under
_TWO_DEV = ("xeon", "upmem_2556")
_THREE_DEV = ("xeon", "titan_v", "upmem_2556")
#: multi-rank device sets: rank 0 is the bare base name
_RANKED_2 = ("xeon", "upmem_2556", "upmem_2556:1")
_RANKED_4 = ("xeon", "upmem_2556", "upmem_2556:1", "upmem_2556:2",
             "upmem_2556:3")

#: paper-scale prefill golden shape: 2 chunks keeps the cross-chunk
#: frontier inside the exact frontier-DP rung (DESIGN.md §10)
PREFILL_PAPER = dict(prefill_len=2048, chunk=1024)
#: long-context banded-prefill golden shape: a 32k prompt under the 4k
#: window in 8k chunks (`prefill_live_from` = [0, 0, 1, 2])
PREFILL_SWA = dict(prefill_len=32768, chunk=8192)
#: reduced banded shape with the same band ([0, 0, 0, 1])
PREFILL_SWA_REDUCED = dict(prefill_len=16, chunk=4)


def shipped_graphs() -> dict:
    """Registry of every shipped graph: name -> (builder, planner device
    set), the reference's registry entry for entry. Names are the keys of
    tests/golden_plans.json."""
    from .. import prim
    builders = {
        "prim-mixed": (
            lambda: mixed_pipeline(m=4096, concrete=False).graph(),
            _TWO_DEV),
        "lm-decode-chain": (
            lambda: decode_pipeline(DecodeDims(), concrete=False).graph(),
            _TWO_DEV),
        "lm-decode-dag": (
            lambda: decode_dag(DecodeDims()), _TWO_DEV),
        "lm-decode-dag-kv-on-host": (
            lambda: decode_dag(DecodeDims(), kv_home="xeon"), _TWO_DEV),
        "lm-prefill-dag": (
            lambda: prefill_dag(DecodeDims(), **PREFILL_PAPER), _TWO_DEV),
        "lm-prefill-dag-reduced": (
            lambda: prefill_dag(REDUCED_DIMS, prefill_len=8, chunk=4),
            _TWO_DEV),
        "lm-moe-decode-dag": (
            lambda: moe_decode_dag(MOE_PAPER_DIMS), _TWO_DEV),
        "lm-moe-decode-dag-reduced": (
            lambda: moe_decode_dag(MOE_REDUCED_DIMS), _TWO_DEV),
        "lm-moe-prefill-dag": (
            lambda: prefill_dag(MOE_PAPER_DIMS, **PREFILL_PAPER), _TWO_DEV),
        "lm-moe-prefill-dag-reduced": (
            lambda: prefill_dag(MOE_REDUCED_DIMS, prefill_len=8, chunk=4),
            _TWO_DEV),
        "lm-moe-decode-dag-int8": (
            lambda: moe_decode_dag(MOE_PAPER_DIMS_INT8), _TWO_DEV),
        "lm-moe-decode-dag-int8-reduced": (
            lambda: moe_decode_dag(MOE_REDUCED_DIMS_INT8), _TWO_DEV),
        "lm-moe-prefill-dag-int8": (
            lambda: prefill_dag(MOE_PAPER_DIMS_INT8, **PREFILL_PAPER),
            _TWO_DEV),
        "lm-moe-prefill-dag-int8-reduced": (
            lambda: prefill_dag(MOE_REDUCED_DIMS_INT8, prefill_len=8,
                                chunk=4), _TWO_DEV),
        "lm-moe-decode-dag-reduced-ep2": (
            lambda: moe_decode_dag(MOE_REDUCED_DIMS, expert_shards=2),
            _RANKED_2),
        "lm-moe-decode-dag-int8-reduced-ep4": (
            lambda: moe_decode_dag(MOE_REDUCED_DIMS_INT8, expert_shards=4),
            _RANKED_4),
        "lm-decode-steps-dag-reduced": (
            lambda: decode_steps_dag(REDUCED_DIMS, n_steps=2), _TWO_DEV),
        "lm-moe-decode-steps-int8-reduced": (
            lambda: decode_steps_dag(MOE_REDUCED_DIMS_INT8, n_steps=2),
            _TWO_DEV),
        "lm-decode-dag-swa4096": (
            lambda: decode_dag(SWA_PAPER_DIMS), _TWO_DEV),
        "lm-decode-dag-swa8-reduced": (
            lambda: decode_dag(SWA_REDUCED_DIMS), _TWO_DEV),
        "lm-moe-decode-dag-int8-swa4096": (
            lambda: moe_decode_dag(MOE_SWA_PAPER_DIMS_INT8), _TWO_DEV),
        "lm-moe-decode-dag-int8-swa8-reduced": (
            lambda: moe_decode_dag(MOE_SWA_REDUCED_DIMS_INT8), _TWO_DEV),
        "lm-prefill-dag-swa4096-32k": (
            lambda: prefill_dag(SWA_PAPER_DIMS, **PREFILL_SWA), _TWO_DEV),
        "lm-prefill-dag-swa8-reduced": (
            lambda: prefill_dag(SWA_REDUCED_DIMS, **PREFILL_SWA_REDUCED),
            _TWO_DEV),
    }
    for counts in prim.all_ref_counts():
        builders[f"prim/{counts.name}"] = (
            (lambda c=counts: prim_graph(c)), _THREE_DEV)
    return builders
