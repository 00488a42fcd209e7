"""Dispatch-backed serving: route prefill AND decode through planner plans.

The port of `repro.serve.dispatch_engine`. `DispatchDecodeStep` replaces
`ServeEngine`'s fused decode step and `DispatchPrefillStep` its one-slot
prefill, both selected with `ServeEngine(..., engine="dispatch")`.
Instead of one forward, each step is decomposed into the stages of its
operator DAG (`dispatch.workloads.decode_dag` / `prefill_dag`) and handed
to the plan executor (`dispatch.executor.PlanExecutor`), which runs the
planner's `Schedule` launch groups in timeline order:

  * host stages (`xeon` / `titan_v` in the model) call their body, one
    face per stage *kind* — all layers share it;
  * PIM stages run as BankGrid local phases (decode: batch slots sharded
    over banks — each bank owns its slots' activations and KV rows, the
    continuous-batching-across-banks layout of DESIGN.md §4; prefill: the
    chunk's token rows shard over banks, weights and the KV prefix
    replicate), one call over the stacked banks;
  * the executed group order IS the schedule's group order, so a chunked
    prefill runs pipelined across chunks (DESIGN.md §11).

Both faces run on the engine's device: on the card every decode `attn`
stage launches the decode-attention kernel (`layers.cached_attention`)
and every prefill `attn` stage the flash kernel with the chunk's
`q_offset`; the projections and MLPs are plain products, as in the
fused forward.

Every stage computes exactly what `models.forward` computes for that
slice of the step (same library calls: `_qkv`, `cache.write_decode`,
`cached_attention`, `mlp_forward`, the MoE pieces, ...), and the decode
faces run at the whole batch whatever the bank count, so a decode step
gives the fused step's bits. The decode attention stage writes the new
K/V row through a view of the layer's cache, in place, as the fused
step does, and each prefill chunk's qkv stage writes its rows into the
slot's view of the cache, where the chunk attention reads its prefix.
The prefill's chunked attention is not bitwise the fused whole-prompt
flash call.

Planning happens once at construction: the model config is mapped to
`DecodeDims`, the DAGs are built with the KV cache homed on the PIM
system, and `placement.plan` runs the ladder (DESIGN.md §10). The chosen
assignment routes stages by name; `force_assignment` overrides it.

Scope: attention decoders with dense OR routed-MoE MLPs (no cross-
attention, SSM or shared experts). MoE layers run as the routed ladder
`router{i}` -> token exchange -> `expert{i}` -> combine exchange ->
`combine{i}` (`_MoeStageMixin`, DESIGN.md §12).
"""

from __future__ import annotations

import time
from functools import partial

import torch

from ..core.bank_parallel import BankGrid
from ..dispatch import workloads
from ..dispatch.executor import FaceCache, PlanExecutor, StageDef
from ..dispatch.placement import Plan, plan as plan_placement
from ..dispatch.plan_cache import PlanCache
from ..kernels import ops
from ..models import ModelConfig
from ..models import cache as cache_lib
from ..models import layers as L
from ..models.config import torch_dtype
from ..models.sharding import tree_map
from ..models.transformer import mask_vocab_padding, quantize_moe_params


def dims_for_config(cfg: ModelConfig, batch_slots: int,
                    max_len: int) -> workloads.DecodeDims:
    """Map a serving config onto the decode DAG's planning dims. The KV
    cache is sized as the engine allocates it — GQA head count and the
    config dtype's itemsize — so the migration charge matches the bytes
    a real migration would move. `cfg.quant == "int8"` maps onto the
    KT2-flip planning configuration (1-byte KV rows, int8-tagged expert
    GEMMs, DESIGN.md §15); `cfg.sliding_window` threads through as
    `DecodeDims.window`."""
    q8 = cfg.quant == "int8"
    return workloads.DecodeDims(
        d_model=cfg.d_model, n_heads=cfg.n_heads, head_dim=cfg.hd,
        d_ff=cfg.d_ff, seq=cache_lib.cache_width(cfg, max_len),
        vocab=cfg.padded_vocab, n_layers=cfg.n_layers, batch=batch_slots,
        n_kv_heads=cfg.n_kv_heads,
        kv_itemsize=1 if q8 else torch_dtype(cfg.dtype).itemsize,
        n_experts=cfg.n_experts, top_k=cfg.top_k, moe_d_ff=cfg.moe_d_ff,
        quant="int8" if q8 else "", window=cfg.sliding_window)


def _check_dispatchable(cfg: ModelConfig) -> None:
    pattern = cfg.layer_pattern()
    ok = (len(pattern) == 1 and pattern[0].kind == "attn"
          and pattern[0].mlp in ("dense", "moe") and not pattern[0].cross_attn
          and not cfg.encoder_layers)
    if not ok:
        raise ValueError(
            f"engine='dispatch' supports dense attention decoders (dense "
            f"or routed-MoE MLPs); {cfg.name} has pattern {pattern}")
    if cfg.rope == "mrope":
        # the reference's dispatch steps pass (B, S) positions where M-RoPE
        # takes (3, B, S) streams (its indexing clamps the missing ones)
        raise ValueError(
            f"engine='dispatch' has no M-RoPE position streams; {cfg.name} "
            "uses M-RoPE")
    if pattern[0].mlp == "moe" and cfg.n_shared_experts:
        raise ValueError(
            f"engine='dispatch' MoE support covers routed experts only "
            f"(router -> exchange -> expert FFNs -> combine); {cfg.name} "
            "has shared experts")


class _LayerParams:
    """Per-layer views of the stacked parameters (and the int8 expert
    weights), made once per params tree: the stages bind them every
    step."""

    def __init__(self):
        self._key = None
        self.layers: list = []

    def get(self, params, cfg: ModelConfig) -> list:
        stacked = params["layers"][0]
        if self._key is not stacked:
            if cfg.quant == "int8" and cfg.n_experts \
                    and "q8" not in stacked["mlp"]:
                stacked = quantize_moe_params(params, cfg)["layers"][0]
            self.layers = [tree_map(lambda t, i=i: t[i], stacked)
                           for i in range(cfg.n_blocks)]
            self._key = params["layers"][0]
        return self.layers


class _MoeStageMixin:
    """Shared MoE stage bodies for the dispatch serving steps: the routed
    ladder `router -> (token exchange) -> expert -> (combine exchange) ->
    combine`, each calling the library slice the fused engine's
    `models.layers.moe_forward` is composed of (`L.moe_dispatch`,
    `L.moe_expert_ffn`/`L.moe_expert_ffn_q8`, `L.moe_combine`), so the
    two paths cannot drift. The router and combine are token-side
    (decode shards slots over banks; prefill replicates them — a chunk's
    capacity cumsum spans the whole chunk); the expert FFN shards the
    EXPERT axis over banks."""

    @staticmethod
    def _router_fn(cfg, x, ln2, router):
        h = L.apply_norm(x, ln2, cfg)
        buf, topi, pos, w, _ = L.moe_dispatch(h, router, cfg)
        return buf, topi, pos, w

    @staticmethod
    def _expert_fn(cfg, buf, wu, wg, wd):
        return L.moe_expert_ffn(buf, {"wu": wu, "wg": wg, "wd": wd}, cfg)

    @staticmethod
    def _expert_fn_ungated(cfg, buf, wu, wd):
        return L.moe_expert_ffn(buf, {"wu": wu, "wd": wd}, cfg)

    @staticmethod
    def _expert_fn_q8(cfg, buf, wuq, su, wgq, sg, wdq, sd):
        return L.moe_expert_ffn_q8(
            buf, {"wu": (wuq, su), "wg": (wgq, sg), "wd": (wdq, sd)}, cfg)

    @staticmethod
    def _expert_fn_q8_ungated(cfg, buf, wuq, su, wdq, sd):
        return L.moe_expert_ffn_q8(buf, {"wu": (wuq, su), "wd": (wdq, sd)},
                                   cfg)

    @staticmethod
    def _combine_fn(cfg, x, out_buf, topi, pos, w):
        return x + L.moe_combine(out_buf, topi, pos, w, x.dtype)

    def _moe_stage_defs(self, token_axis: int | None):
        """The three MoE StageDefs: `token_axis` is the bank-shard axis of
        token-side tensors (0 for decode's slot sharding; None for
        prefill). The expert face shards the expert axis (buf axis 1,
        weight and scale axis 0) over banks."""
        ta, cfg = token_axis, self.cfg
        if cfg.quant == "int8":
            if cfg.gated_mlp:
                expert = StageDef("expert", partial(self._expert_fn_q8, cfg),
                                  (1, 0, 0, 0, 0, 0, 0), (1,))
            else:
                expert = StageDef("expert",
                                  partial(self._expert_fn_q8_ungated, cfg),
                                  (1, 0, 0, 0, 0), (1,))
        elif cfg.gated_mlp:
            expert = StageDef("expert", partial(self._expert_fn, cfg),
                              (1, 0, 0, 0), (1,))
        else:
            expert = StageDef("expert", partial(self._expert_fn_ungated, cfg),
                              (1, 0, 0), (1,))
        return [
            StageDef("router", partial(self._router_fn, cfg),
                     (ta, None, None), (ta, ta, ta, ta)),
            expert,
            StageDef("combine", partial(self._combine_fn, cfg), (ta,) * 5,
                     (ta,)),
        ]

    #: expert-parallel shard count; decode overrides per instance
    expert_shards: int = 1

    def _expert_out(self, env, i, chunk: str):
        """The (B, E, C, D) expert-output buffer the combine gathers from:
        the single expert face's output, or the R shards' outputs
        reassembled along the expert axis (exact: experts compute
        independently)."""
        if self.expert_shards == 1:
            return env[f"expert{i}{chunk}"]
        return torch.cat([env[f"expert{i}@r{j}{chunk}"]
                          for j in range(self.expert_shards)], dim=1)

    def _bind_moe(self, name, env, lp, chunk: str = ""):
        """Argument tuples for the MoE stages. Expert-parallel shard
        stages (`"expert{i}@r{j}"`) get their slice of the dispatch buffer
        and of the expert-axis weight stacks."""
        kind, i, _ = workloads.parse_stage_name(name)
        mp = lp[i]["mlp"]
        if kind == "router":
            return env[f"o{i}{chunk}"], lp[i]["ln2"], mp["router"]
        if kind == "expert":
            buf = env[f"router{i}{chunk}"][0]
            j = workloads.stage_shard(name)
            sl = slice(None)
            if j is not None:
                es = self.cfg.n_experts // self.expert_shards
                sl = slice(j * es, (j + 1) * es)
                buf = buf[:, sl]
            if self.cfg.quant == "int8":
                q = mp["q8"]
                wuq, su = (w[sl] for w in q["wu"])
                wdq, sd = (w[sl] for w in q["wd"])
                if self.cfg.gated_mlp:
                    wgq, sg = (w[sl] for w in q["wg"])
                    return buf, wuq, su, wgq, sg, wdq, sd
                return buf, wuq, su, wdq, sd
            return ((buf, mp["wu"][sl], mp["wg"][sl], mp["wd"][sl])
                    if self.cfg.gated_mlp
                    else (buf, mp["wu"][sl], mp["wd"][sl]))
        if kind == "combine":
            _, topi, pos, w = env[f"router{i}{chunk}"]
            return (env[f"o{i}{chunk}"], self._expert_out(env, i, chunk),
                    topi, pos, w)
        raise KeyError(f"unknown MoE stage {name!r}")


class _Stages(_MoeStageMixin):
    """The stage bodies the decode and prefill steps share. Each body is a
    static function of the config, bound into its `StageDef` with
    `functools.partial`: the `FaceCache` then refers to no step, so a
    dropped engine frees its weights and cache at once (no cycle through
    the step)."""

    @staticmethod
    def _qkv_fn(cfg, x, sin, cos, ln1, attn_p):
        h = L.apply_norm(x, ln1, cfg)
        rope = cfg.rope != "none"
        return L._qkv(h, attn_p, cfg, rope_sin=sin if rope else None,
                      rope_cos=cos if rope else None)

    @staticmethod
    def _o_fn(cfg, x, o, attn_p):
        return x + L.attn_out(o, attn_p, x.dtype)

    @staticmethod
    def _mlp_fn(cfg, x, ln2, mlp_p):
        h = L.apply_norm(x, ln2, cfg)
        return x + L.mlp_forward(h, mlp_p, cfg)

    @staticmethod
    def _head_fn(cfg, x, norm_p, wv):
        x = L.apply_norm(x, norm_p, cfg)
        return mask_vocab_padding(x @ wv.to(x.dtype).t(), cfg)

    @staticmethod
    def _embed_fn(cfg, table, tokens, positions):
        x = table[tokens].to(torch_dtype(cfg.dtype))
        if cfg.rope == "none":
            shape = (*tokens.shape, cfg.hd // 2)
            z = torch.zeros(shape, dtype=torch.float32, device=tokens.device)
            return x, z, z
        sin, cos = L.rope_sincos(positions, cfg)
        return x, sin, cos

    def _expected_stages(self, chunks) -> set:
        """The executable stage names of one step (`chunks` None for
        decode, else the chunk count): the routing contract with the DAG
        builders' node names."""
        cfg = self.cfg
        sfx = [""] if chunks is None else [f"/c{c}" for c in range(chunks)]
        mlp = (("mlp",) if not self._moe else
               ("router", "combine") if self.expert_shards > 1
               else ("router", "expert", "combine"))
        out = {"head"} | {f"embed{s}" for s in sfx}
        shards = range(self.expert_shards if self.expert_shards > 1 else 0)
        for s in sfx:
            for i in range(cfg.n_blocks):
                out |= {f"{k}{i}{s}" for k in ("qkv", "attn", "o") + mlp}
                out |= {f"expert{i}@r{j}{s}" for j in shards}
        return out


def make_dispatch_decode_step(cfg: ModelConfig,
                              **kwargs) -> "DispatchDecodeStep":
    """The fused decode step's dispatch twin: plan the decode DAG and bind
    the planner's chosen plan into an executable step."""
    return DispatchDecodeStep(cfg, **kwargs)


class DispatchDecodeStep(_Stages):
    """Planner-routed decode step — a thin workload adapter over
    `dispatch.executor.PlanExecutor`. `step(params, cache, tokens,
    slot_pos, live_mask, generator)` returns `(next_tokens (B, 1), cache,
    new_pos)`, writing the new K/V rows into `cache` in place. MoE configs
    route each layer's routed ladder through the same executor, with
    expert FFNs sharded over the banks when placed on PIM."""

    def __init__(self, cfg: ModelConfig, *, batch_slots: int, max_len: int,
                 temperature: float = 0.0, grid: BankGrid | None = None,
                 devices: tuple[str, ...] = ("xeon", "upmem_2556"),
                 kv_home: str | None = "upmem_2556",
                 objective: str = "serial", expert_shards: int = 1,
                 force_assignment: dict[str, str] | None = None,
                 device=None):
        _check_dispatchable(cfg)
        self.cfg = cfg
        self.temperature = temperature
        self.grid = grid or BankGrid(1, device)
        if batch_slots % self.grid.n_banks:
            raise ValueError(f"batch_slots={batch_slots} must divide over "
                             f"{self.grid.n_banks} bank(s)")
        self.expert_shards = int(expert_shards)
        self._moe = cfg.n_experts > 0
        t0 = time.perf_counter()
        self.dag = workloads.decode_dag(
            dims_for_config(cfg, batch_slots, max_len), kv_home=kv_home,
            expert_shards=self.expert_shards)
        self.plan: Plan = plan_placement(self.dag, devices=devices,
                                         objective=objective)
        #: host seconds of planning: the DAG's census and the placement
        self.plan_s = time.perf_counter() - t0
        self.assignment = dict(self.plan.assignment)
        if force_assignment:
            self.assignment.update(force_assignment)
        # the executable stage names and the DAG's node names are the
        # routing contract: drift fails here, never falls back to the host
        missing = self._expected_stages(None) - set(self.assignment)
        if missing:
            raise ValueError(f"plan is missing stages {sorted(missing)}; "
                             "decode_dag node names drifted from the "
                             "executable stages")
        #: one face per stage kind, shared by all layers
        self.faces = FaceCache(self._stage_defs(), self.grid)
        self.executor = PlanExecutor(self.dag, self.assignment, self.faces)
        self._lp = _LayerParams()
        #: optional `dispatch.trace.Trace` (ServeEngine.attach_tracer)
        self.tracer = None

    def _stage_defs(self):
        """Batch slots shard on axis 0 of every flowing tensor (and of the
        layer's cache), weights replicate. MoE layers swap the dense `mlp`
        for the routed trio."""
        cfg = self.cfg
        mlp_defs = (self._moe_stage_defs(token_axis=0) if self._moe
                    else [StageDef("mlp", partial(self._mlp_fn, cfg),
                                   (0, None, None), (0,))])
        return [
            StageDef("embed", partial(self._embed_fn, cfg), (None, 0, 0),
                     (0, 0, 0)),
            StageDef("qkv", partial(self._qkv_fn, cfg),
                     (0, 0, 0, None, None), (0, 0, 0)),
            StageDef("attn", partial(self._attn_fn, cfg), (0,) * 6, (0,)),
            StageDef("o", partial(self._o_fn, cfg), (0, 0, None), (0,)),
            *mlp_defs,
            StageDef("head", partial(self._head_fn, cfg), (0, None, None),
                     (0,)),
        ]

    @staticmethod
    def _attn_fn(cfg, q, k, v, k_cache, v_cache, attn_index):
        """Write the step's K/V row into the layer's cache (views: in
        place) and attend over it: the decode-attention kernel on the
        card."""
        kv = cache_lib.write_decode({"k": k_cache, "v": v_cache}, k, v,
                                    attn_index, k_cache.shape[1])
        return L.cached_attention(q, kv["k"], kv["v"], attn_index, cfg)

    def _bind(self, params, cache, tokens, slot_pos):
        """The executor's workload surface: map a decode-DAG node name to
        its stage argument tuple, reading prior results from `env`."""
        cfg = self.cfg
        lp = self._lp.get(params, cfg)
        kv_stack = cache["layers"][0]
        wv = params["embed"] if cfg.tie_embeddings else params["unembed"]
        res_kind = "combine" if self._moe else "mlp"

        def residual(env, i):
            return env[f"{res_kind}{i - 1}"] if i else env["embed"][0]

        def bind(name, env):
            kind, i, _ = workloads.parse_stage_name(name)
            if kind == "embed":
                return params["embed"], tokens, slot_pos[:, None]
            if kind == "qkv":
                _, sin, cos = env["embed"]
                return (residual(env, i), sin, cos, lp[i]["ln1"],
                        lp[i]["attn"])
            if kind == "attn":
                q, k, v = env[f"qkv{i}"]
                return (q, k, v, kv_stack["k"][i], kv_stack["v"][i],
                        slot_pos)
            if kind == "o":
                return residual(env, i), env[f"attn{i}"], lp[i]["attn"]
            if kind == "mlp":
                return env[f"o{i}"], lp[i]["ln2"], lp[i]["mlp"]
            if kind in ("router", "expert", "combine"):
                return self._bind_moe(name, env, lp)
            if kind == "head":
                return (env[f"{res_kind}{cfg.n_blocks - 1}"],
                        params["final_norm"], wv)
            raise KeyError(f"unknown decode stage {name!r}")
        return bind

    @torch.no_grad()
    def logits(self, params, cache, tokens, slot_pos):
        """Run the planned step: the (B, 1, V) logits of the next token,
        the K/V rows written into `cache` in place and its index moved on
        as the fused step moves it."""
        # keep: the head's logits are read after the run, and every
        # layer's qkv reads embed's sin/cos although the DAG only edges
        # embed -> qkv0/o0
        env = self.executor.run(self._bind(params, cache, tokens, slot_pos),
                                keep={"head", "embed"}, tracer=self.tracer)
        cache["index"] = torch.maximum(
            cache["index"] + 1, slot_pos.max() + 1).to(torch.int32)
        return env["head"]

    def __call__(self, params, cache, tokens, slot_pos, live_mask,
                 generator=None):
        from .engine import sample
        logits = self.logits(params, cache, tokens, slot_pos)
        nxt = sample(logits[:, -1], generator, self.temperature)
        nxt = torch.where(live_mask, nxt, tokens[:, 0])
        new_pos = torch.where(live_mask, slot_pos + 1, slot_pos)
        return nxt[:, None], cache, new_pos


# ------------------------------------------------------------------- #
# planner-routed chunked prefill
# ------------------------------------------------------------------- #

def _is_unit_range(pos) -> bool:
    return isinstance(pos, range) and pos.step == 1 and len(pos) > 0


class DispatchPrefillStep(_Stages):
    """Planner-routed chunked prefill with the engine's prefill-one
    signature: `(params, cache, tokens, slot) -> last_logits`, the
    prompt's K/V rows written into the cache's `slot` in place — a thin
    workload adapter over `dispatch.executor.PlanExecutor`.

    The prompt is processed `chunk` tokens at a time; each chunk's
    per-layer qkv -> attention -> o -> mlp ladder runs on the device the
    planner assigned to the matching `workloads.prefill_dag` node
    (`"qkv{layer}/c{chunk}"`, ...). Chunk attention attends each query
    row causally over the K/V rows produced so far, banded by
    `workloads.prefill_live_from` under a sliding window: queries at
    absolute positions c0.., keys at offs[live_from[c]]..: one call of
    the flash kernel with `q_offset` = the first query's position minus
    the first key's (its plain version on the CPU). Each chunk's qkv
    stage writes its K/V rows straight into the slot's rows of the
    layer's cache and the attention reads its prefix back as a view (a
    prompt longer than a ring cache goes through a scratch buffer folded
    in by `cache.write_prefill`); the head runs on the final chunk only.

    Execution is PIPELINED across chunks: the executor walks the
    schedule's launch groups over the prompt's own structural prefill
    DAG. One executor is built per distinct chunk-split signature and
    cached in a `dispatch.PlanCache`; all share one `FaceCache`.

    Planning happens once, on a canonical DAG of `planned_chunks`
    chunks (prompts with more chunks reuse the last planned chunk's
    placement — the `min(c, planned-1)` clamp; prompts with fewer use a
    prefix). Beyond 2 chunks the ladder's bounded branch-and-bound rung
    plans it (`state_budget`, `bnb_budget`; DESIGN.md §10).

    PIM-assigned stages shard the chunk's token rows over banks (weights
    and the KV prefix replicate); a chunk length not divisible by the
    bank count falls back to the host face for that call, counted in
    `faces.fallbacks`.

    MoE configs run each chunk's routed ladder with expert capacity
    derived from the CHUNK length, so multi-chunk MoE prefill is not
    output-equivalent to the fused whole-prompt forward (a single chunk
    covering the prompt is)."""

    def __init__(self, cfg: ModelConfig, *, max_len: int,
                 grid: BankGrid | None = None,
                 devices: tuple[str, ...] = ("xeon", "upmem_2556"),
                 kv_home: str | None = "upmem_2556",
                 chunk: int | None = None, planned_chunks: int = 4,
                 objective: str = "overlapped",
                 state_budget: int = 200_000, bnb_budget: int = 20_000,
                 force_assignment: dict[str, str] | None = None,
                 device=None):
        _check_dispatchable(cfg)
        self.cfg = cfg
        self.grid = grid or BankGrid(1, device)
        self.max_len = max_len
        self.chunk = int(chunk if chunk is not None else min(512, max_len))
        if self.chunk < 1:
            raise ValueError(f"prefill chunk must be >= 1, got {self.chunk}")
        canonical = min(max_len, planned_chunks * self.chunk)
        canonical_splits = workloads.prefill_chunk_splits(canonical,
                                                          self.chunk)
        self.n_chunks_planned = len(canonical_splits)
        self._dims = dims_for_config(cfg, 1, max_len)
        self._kv_home = kv_home
        self._moe = cfg.n_experts > 0
        t0 = time.perf_counter()
        self.dag = workloads.prefill_dag(
            self._dims, prefill_len=canonical, chunk=self.chunk, batch=1,
            kv_home=kv_home)
        self.plan: Plan = plan_placement(
            self.dag, devices=devices, objective=objective,
            state_budget=state_budget, bnb_budget=bnb_budget)
        #: host seconds of planning: the DAG's census and the placement
        self.plan_s = time.perf_counter() - t0
        self.assignment = dict(self.plan.assignment)
        if force_assignment:
            self.assignment.update(force_assignment)
        missing = (self._expected_stages(self.n_chunks_planned)
                   - set(self.assignment))
        if missing:
            raise ValueError(f"plan is missing stages {sorted(missing)}; "
                             "prefill_dag node names drifted from the "
                             "executable stages")
        self.faces = FaceCache(self._stage_defs(), self.grid)
        #: per chunk-split-signature executors, sharing `faces`
        self.executor_cache = PlanCache(maxsize=16)
        self.executor = self._executor_for(canonical_splits)
        self._lp = _LayerParams()
        #: optional `dispatch.trace.Trace` (ServeEngine.attach_tracer)
        self.tracer = None

    def _stage_defs(self):
        """A chunk's token rows shard on axis 1, weights and the prompt's
        K/V rows replicate (the positions are host ranges). MoE layers
        swap the dense `mlp` for the routed trio — router/combine
        replicate, the expert FFN shards the EXPERT axis over banks."""
        cfg = self.cfg
        mlp_defs = (self._moe_stage_defs(token_axis=None) if self._moe
                    else [StageDef("mlp", partial(self._mlp_fn, cfg),
                                   (1, None, None), (1,))])
        return [
            StageDef("embed", partial(self._embed_fn, cfg), (None, 1, 1),
                     (1, 1, 1)),
            StageDef("qkv", partial(self._qkv_write_fn, cfg),
                     (1, 1, 1, None, None, None), (1,)),
            StageDef("attn", partial(self._attn_fn, cfg),
                     (1, None, None, None, None), (1,)),
            StageDef("o", partial(self._o_fn, cfg), (1, 1, None), (1,)),
            *mlp_defs,
            StageDef("head", partial(self._head_fn, cfg), (1, None, None),
                     (1,)),
        ]

    @staticmethod
    def _qkv_write_fn(cfg, x, sin, cos, ln1, attn_p, rows):
        """The chunk's q, k, v; k and v are written into `rows` (the
        chunk's rows of the prompt's K/V, views) in place and q is
        returned."""
        q, k, v = _Stages._qkv_fn(cfg, x, sin, cos, ln1, attn_p)
        rows["k"].copy_(k)
        rows["v"].copy_(v)
        return q

    @staticmethod
    def _attn_fn(cfg, q, kp, vp, q_pos, k_pos):
        """Chunk attention with the absolute query and key positions passed
        explicitly, as unit-step ranges: a slot index only equals its
        position in a full cache, and a banded prefix does not even start
        at 0. The flash kernel (its plain version on the CPU) masks by
        `q_offset = q_pos[0] - k_pos[0]`."""
        if kp.shape[1] != len(k_pos) or q.shape[1] != len(q_pos):
            raise ValueError(
                f"attn stage got {kp.shape[1]} KV rows but {len(k_pos)} key "
                "positions — slot index != absolute position here (ring "
                "cache or banded prefix?); refusing to mis-mask")
        if not (_is_unit_range(q_pos) and _is_unit_range(k_pos)):
            raise ValueError("attn stage takes query and key positions as "
                             "unit-step ranges")
        return ops.flash_attention(q, kp, vp, causal=True,
                                   window=cfg.sliding_window,
                                   q_offset=q_pos[0] - k_pos[0])

    # ------------------------------------------------------------- #
    def _clamped(self, name: str) -> str:
        """The planned stage a (possibly beyond-horizon) execution stage
        routes as: the `min(c, planned-1)` clamp."""
        kind, layer, c = workloads.parse_stage_name(name)
        if c is None:
            return name
        return (f"{kind}{'' if layer is None else layer}"
                f"/c{min(c, self.n_chunks_planned - 1)}")

    def _skeleton(self, s_len: int):
        return workloads.prefill_dag(
            self._dims, prefill_len=s_len, chunk=self.chunk, batch=1,
            kv_home=self._kv_home, costed=False)

    def _executor_for(self, splits: list[int]) -> PlanExecutor:
        """The executor for one chunk-split signature, reused through
        `executor_cache`: the structural prefill DAG of the actual chunks
        supplies the node names / edges / timeline order; the planned
        assignment routes it, clamped past the planned horizon."""
        def build() -> PlanExecutor:
            skeleton = self._skeleton(sum(splits))
            assignment = {name: self.assignment[self._clamped(name)]
                          for name in skeleton.nodes}
            return PlanExecutor(skeleton, assignment, self.faces)
        return self.executor_cache.get_or_plan(tuple(splits), build)

    def devices_for(self, s_len: int) -> dict[str, str]:
        """Stage name -> device for a prompt of `s_len` tokens (the
        clamped planned assignment the executor routes)."""
        return {name: self.assignment[self._clamped(name)]
                for name in self._skeleton(s_len).nodes}

    def chunk_splits(self, s_len: int) -> list[int]:
        """Chunk lengths a prompt of `s_len` tokens is processed in — the
        split the planned DAG uses (`workloads.prefill_chunk_splits`)."""
        return workloads.prefill_chunk_splits(s_len, self.chunk)

    # ------------------------------------------------------------- #
    def _bind(self, params, toks, splits, prompt_kv):
        """The executor's workload surface for one prompt: map a prefill
        node name (`"{kind}{layer}/c{chunk}"`) to its argument tuple.
        `prompt_kv[i]` holds layer i's K/V rows of the whole prompt: each
        chunk's qkv stage writes its rows there, and its attention reads
        the LIVE prefix back as a view — rows from `offs[live_from[c]]`,
        the executable twin of the DAG's fan-in edges, banded by
        `workloads.prefill_live_from`."""
        cfg = self.cfg
        lp = self._lp.get(params, cfg)
        wv = params["embed"] if cfg.tie_embeddings else params["unembed"]
        offs = [0]
        for t in splits:
            offs.append(offs[-1] + t)
        live_from = workloads.prefill_live_from(splits, cfg.sliding_window)
        res_kind = "combine" if self._moe else "mlp"
        dev = toks.device

        def bind(name, env):
            kind, i, c = workloads.parse_stage_name(name)
            if kind == "head":
                return (env[f"{res_kind}{cfg.n_blocks - 1}"
                            f"/c{len(splits) - 1}"],
                        params["final_norm"], wv)
            c0, t = offs[c], splits[c]
            if kind == "embed":
                pos = torch.arange(c0, c0 + t, dtype=torch.int32,
                                   device=dev)[None, :]
                return params["embed"], toks[:, c0:c0 + t], pos
            if kind == "qkv":
                x = (env[f"{res_kind}{i - 1}/c{c}"] if i
                     else env[f"embed/c{c}"][0])
                _, sin, cos = env[f"embed/c{c}"]
                rows = {n: r[:, c0:c0 + t] for n, r in prompt_kv[i].items()}
                return x, sin, cos, lp[i]["ln1"], lp[i]["attn"], rows
            if kind == "attn":
                k0 = offs[live_from[c]]
                kv = prompt_kv[i]
                return (env[f"qkv{i}/c{c}"], kv["k"][:, k0:c0 + t],
                        kv["v"][:, k0:c0 + t], range(c0, c0 + t),
                        range(k0, c0 + t))
            if kind == "o":
                x = (env[f"{res_kind}{i - 1}/c{c}"] if i
                     else env[f"embed/c{c}"][0])
                return x, env[f"attn{i}/c{c}"], lp[i]["attn"]
            if kind == "mlp":
                return env[f"o{i}/c{c}"], lp[i]["ln2"], lp[i]["mlp"]
            if kind in ("router", "expert", "combine"):
                return self._bind_moe(name, env, lp, chunk=f"/c{c}")
            raise KeyError(f"unknown prefill stage {name!r}")
        return bind

    @staticmethod
    def _prompt_kv(cache, slot: int, s_len: int) -> list[dict]:
        """Per layer, where the prompt's K/V rows are written: the slot's
        rows [0, s_len) of the layer's cache (views; the rows past the
        prompt are zeroed, as the fused prefill leaves them), or, when
        the prompt is longer than a ring cache, a scratch buffer that
        `cache.write_prefill` folds into the ring after the run."""
        kv_stack = cache["layers"][0]
        out = []
        for i in range(kv_stack["k"].shape[0]):
            one = {n: kv_stack[n][i, slot:slot + 1] for n in ("k", "v")}
            if s_len <= one["k"].shape[1]:
                for r in one.values():
                    r[:, s_len:].zero_()
                out.append({n: r[:, :s_len] for n, r in one.items()})
            else:
                out.append({n: r.new_empty((1, s_len, *r.shape[2:]))
                            for n, r in one.items()})
        return out

    @torch.no_grad()
    def __call__(self, params, cache, tokens, slot: int):
        toks = tokens[None]              # (1, S) like the fused prefill
        splits = self.chunk_splits(int(toks.shape[1]))
        s_len = sum(splits)
        prompt_kv = self._prompt_kv(cache, slot, s_len)
        executor = self._executor_for(splits)
        # keep: every layer's qkv binds its chunk's embed output (sin/cos)
        # although the DAG only edges embed/c -> qkv0/c, o0/c
        env = executor.run(
            self._bind(params, toks, splits, prompt_kv),
            keep={"head", *(f"embed/c{c}" for c in range(len(splits)))},
            tracer=self.tracer)
        kv_stack = cache["layers"][0]
        if s_len > kv_stack["k"].shape[2]:       # fold into the ring
            for i, kv in enumerate(prompt_kv):
                cache_lib.write_prefill(
                    {n: kv_stack[n][i, slot:slot + 1] for n in ("k", "v")},
                    kv["k"], kv["v"])
        cache["index"] = torch.maximum(
            cache["index"], torch.tensor(s_len, dtype=torch.int32,
                                         device=cache["index"].device))
        return env["head"][0, -1]
