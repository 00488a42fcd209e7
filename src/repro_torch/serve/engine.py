"""Serving: one-slot prefill per arrival and batched decode steps over a
slot-based KV cache (continuous batching).

Counterpart of `repro.serve.engine`. Two backends share the loop: the
fused steps (`engine="jit"`, one forward a step) and the planner-routed
steps (`engine="dispatch"`, `serve.dispatch_engine`): decode over the
decode DAG, prefill chunked over the prefill DAG, both through the plan
executor's schedule timeline (DESIGN.md §9-§11), with the same greedy
tokens. Requests of different lengths share one batched cache;
each slot keeps its own position, passed to the model as `positions`, so
one decode step advances every live slot by one token whatever the skew.
Greedy sampling by default; temperature sampling draws from the engine's
`torch.Generator` (its bits differ from `jax.random`'s). With
`cfg.quant == "int8"` the engine quantizes the MoE expert weights once,
at construction, and every forward runs on those integers.

Every admission and every decode step records one event of its host
seconds, split into launch (the work issued) and sync (the wait for the
device), into `RECENT` or the attached tracer; while tracing is on
(`repro_torch.spans`) the spans inside them land there too.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from ..device import resolve_device
from ..dispatch.trace import Trace, scope, span
from ..models import ModelConfig, forward, init_cache, quantize_moe_params

#: events `RECENT` holds: some minutes of decode steps, and with them the
#: spans of a few seconds under the profiler
RECENT_CAP = 1 << 16

#: The operator's view of the process's recent serving history: every
#: engine's `prefill_step` and `decode_step` events, and the spans inside
#: them while the profiler records, unless a tracer is attached; the last
#: `RECENT_CAP` of them, the oldest dropped first. `RECENT.origin + e.t0`
#: is on the host clock (`time.perf_counter`).
RECENT = Trace("serve.recent", cap=RECENT_CAP)


def make_prefill_step(cfg: ModelConfig, shd=None):
    """(params, cache, batch_inputs) -> (last_logits, cache): the
    reference's prefill step (`forward` with the cache, under no_grad);
    the cache is written in place and returned."""
    def prefill_step(params, cache, inputs):
        with torch.no_grad():
            logits, cache, _ = forward(params, cfg, cache=cache, shd=shd,
                                       **inputs)
        return logits[:, -1], cache
    return prefill_step


def make_decode_step(cfg: ModelConfig, shd=None):
    """(params, cache, tokens (B,1)) -> (logits (B,V), cache)."""
    def decode_step(params, cache, tokens):
        with torch.no_grad():
            logits, cache, _ = forward(params, cfg, tokens=tokens,
                                       cache=cache, shd=shd)
        return logits[:, -1], cache
    return decode_step


def sample(logits, generator=None, temperature: float = 0.0):
    """Greedy argmax (`temperature <= 0`) or temperature sampling over the
    last axis of `logits`; returns int32 token ids."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(flat, 1, generator=generator)
    return out.reshape(probs.shape[:-1]).to(torch.int32)


def _scatter_slot(dst, src, slot: int) -> None:
    """Copy row 0 of every (blocks, 1, ...) leaf of the cache tree `src`
    into row `slot` of the matching (blocks, B, ...) leaf of `dst`."""
    if isinstance(dst, dict):
        for name in dst:
            _scatter_slot(dst[name], src[name], slot)
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src):
            _scatter_slot(d, s, slot)
    else:
        dst[:, slot] = src[:, 0]


@dataclasses.dataclass
class Request:
    """One serving request: an int prompt, a new-token budget, and the
    tokens generated so far (`out_tokens`, filled by the engine).
    `first_token_at` is the host clock (`time.perf_counter`) when the first
    token was known."""
    rid: int
    prompt: torch.Tensor         # (S,) int
    max_new_tokens: int
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    first_token_at: float | None = None


class ServeEngine:
    """Slot-based batched decoding over a fixed batch of cache slots.

    Single-sequence prefill per arrival (depth-first admission) + batched
    decode for all live slots. `device` None means the card; there is no
    silent fall back to the CPU. Counters: `n_prefills`, `n_decode_steps`
    (decode forward calls), and the host seconds spent in each
    (`prefill_s`, `decode_s`, each ending in the step's one host sync).

    `engine="dispatch"` routes both phases through the offload planner.
    `dispatch_kwargs` go to `DispatchDecodeStep` (`grid`, `devices`,
    `kv_home`, `objective`, `expert_shards`, `force_assignment`), except
    the `prefill_*` keys, which configure `DispatchPrefillStep`:
    `prefill_chunk`, `prefill_objective`, `prefill_force_assignment`,
    and `prefill_engine="jit"`, which keeps
    prefill on the fused path. `dispatch_plan` / `prefill_plan` are the
    planners' plans (None on the fused path).
    """

    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int,
                 max_len: int, temperature: float = 0.0,
                 eos_id: int | None = None, seed: int = 0, device=None,
                 engine: str = "jit", dispatch_kwargs: dict | None = None):
        if engine not in ("jit", "dispatch"):
            raise ValueError(f"engine must be 'jit' or 'dispatch', "
                             f"got {engine!r}")
        if engine == "dispatch":
            from .dispatch_engine import _check_dispatchable
            _check_dispatchable(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"engine on {self.device}")
        self.cfg = cfg
        self.params = (quantize_moe_params(params, cfg)
                       if cfg.quant == "int8" else params)
        self.n_slots = batch_slots
        self.max_len = max_len
        self.temperature = temperature
        self.eos_id = eos_id
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        # per-slot caches live stacked in one batched cache; the model's
        # cache carries one global index, per-slot positions live here
        self.cache = init_cache(cfg, batch_slots, max_len, self.device)
        self.slot_pos = torch.zeros(batch_slots, dtype=torch.int32,
                                    device=self.device)
        # liveness on the host (for the loop) and on the device (for the
        # step), so a step uploads nothing and syncs once
        self.slot_live = [False] * batch_slots
        self.live_mask = torch.zeros(batch_slots, dtype=torch.bool,
                                     device=self.device)
        self.slot_req: list[Request | None] = [None] * batch_slots
        self.last_tok = torch.zeros((batch_slots, 1), dtype=torch.int32,
                                    device=self.device)
        self.n_prefills = self.n_decode_steps = 0
        self.prefill_s = self.decode_s = 0.0
        self.engine = engine
        self.tracer = None               # dispatch.trace.Trace | None
        self.dispatch_plan = self.prefill_plan = None
        self._dispatch_decode = self._dispatch_prefill = None
        if engine == "dispatch":
            self._init_dispatch(dict(dispatch_kwargs or {}))

    def _init_dispatch(self, dk: dict) -> None:
        """Plan both serving phases (serve.dispatch_engine): decode over
        the decode DAG, prefill chunked over the prefill DAG; PIM stages
        run as BankGrid phases, host stages as plain calls."""
        from ..core.bank_parallel import BankGrid
        from .dispatch_engine import DispatchDecodeStep, DispatchPrefillStep
        pk = {"chunk": dk.pop("prefill_chunk", None),
              "objective": dk.pop("prefill_objective", "overlapped"),
              "force_assignment": dk.pop("prefill_force_assignment", None)}
        # `prefill_engine="jit"` keeps prefill on the fused path: the
        # dispatch prefill's chunked attention is not bitwise the fused
        # whole-prompt call, so decode-only bitwise gates prefill fused
        prefill_engine = dk.pop("prefill_engine", "dispatch")
        if prefill_engine not in ("dispatch", "jit"):
            raise ValueError(f"prefill_engine must be 'dispatch' or "
                             f"'jit', got {prefill_engine!r}")
        dk.setdefault("grid", BankGrid(1, self.device))
        self._dispatch_decode = DispatchDecodeStep(
            self.cfg, batch_slots=self.n_slots, max_len=self.max_len,
            temperature=self.temperature, **dk)
        self.dispatch_plan = self._dispatch_decode.plan
        if prefill_engine == "dispatch":
            self._dispatch_prefill = DispatchPrefillStep(
                self.cfg, max_len=self.max_len, grid=dk["grid"],
                devices=dk.get("devices", ("xeon", "upmem_2556")),
                kv_home=dk.get("kv_home", "upmem_2556"), **pk)
            self.prefill_plan = self._dispatch_prefill.plan

    # ------------------------------------------------------------- #
    @torch.no_grad()
    def _decode_step(self):
        if self._dispatch_decode is not None:
            self.last_tok, self.cache, self.slot_pos = self._dispatch_decode(
                self.params, self.cache, self.last_tok, self.slot_pos,
                self.live_mask, self.generator)
            return
        positions = self.slot_pos[:, None]
        # index drives slot addressing; per-slot validity is the per-row
        # positions array (cache index is the max position across slots)
        logits, self.cache, _ = forward(self.params, self.cfg,
                                        tokens=self.last_tok,
                                        cache=self.cache, positions=positions)
        with span("engine.sample"):
            nxt = sample(logits[:, -1], self.generator, self.temperature)
        # dead slots keep their last token and don't advance
        live = self.live_mask
        self.last_tok = torch.where(live, nxt, self.last_tok[:, 0])[:, None]
        self.slot_pos = torch.where(live, self.slot_pos + 1, self.slot_pos)

    @torch.no_grad()
    def _prefill_one(self, tokens, slot: int):
        """Prefill one slot: run the single sequence through a one-slot
        cache, then copy every leaf of it (KV rows, cross K/V, recurrent
        states) into row `slot` of the batched cache. Returns the last
        position's logits."""
        if self._dispatch_prefill is not None:
            return self._dispatch_prefill(self.params, self.cache, tokens,
                                          slot)
        with span("engine.prefill.cache"):
            one = init_cache(self.cfg, 1, self.max_len, self.device)
        logits, one, _ = forward(self.params, self.cfg, tokens=tokens[None],
                                 cache=one)
        with span("engine.prefill.cache"):
            _scatter_slot(self.cache["layers"], one["layers"], slot)
            self.cache["index"] = torch.maximum(self.cache["index"],
                                                one["index"])
        return logits[0, -1]

    # ------------------------------------------------------------- #
    def attach_tracer(self, tracer) -> None:
        """Attach a `dispatch.trace.Trace`: the serving loop records into
        it, in place of `RECENT`, one `prefill_step` span per admission
        (`rid`, `slot`, `prompt_len`, `launch_s`, `sync_s`) and one
        `decode_step` span per batched step (`step`, `n_live`, `launch_s`,
        `sync_s`), and, tracing being on while it is attached, the `span`
        events inside them (`repro_torch.spans`). Under
        `engine="dispatch"` the tracer also threads through both
        planner-routed steps into `PlanExecutor.run` (per-node compute
        spans, channel occupancy) and the FaceCache (compile vs
        cache-hit). Pass None to detach."""
        self.tracer = tracer
        for step in (self._dispatch_decode, self._dispatch_prefill):
            if step is not None:
                step.tracer = tracer

    def prefill_splits(self, plen: int) -> list[int]:
        """Chunk lengths a `plen`-token prompt prefills in: the dispatch
        prefill step's chunk grid when that path is active, one fused
        chunk otherwise — the chunk-splits component of the batch
        signature a plan cache keys prefill pricing by."""
        if self._dispatch_prefill is not None:
            return self._dispatch_prefill.chunk_splits(plen)
        return [int(plen)]

    @property
    def n_free(self) -> int:
        """Number of free (admittable) cache slots right now."""
        return self.slot_live.count(False)

    def admit(self, req: Request) -> bool:
        """Admit a request into a free slot (prefill now). False if full.

        Raises ValueError for prompts the slot cache cannot hold
        (`len(prompt) >= max_len`: the slot must fit the prompt plus at
        least one generated token) and for non-positive token budgets. A
        request whose budget or EOS is already satisfied by its FIRST
        sampled token finishes at admit: it is marked done and the slot
        stays free."""
        try:
            slot = self.slot_live.index(False)
        except ValueError:
            return False
        plen = int(req.prompt.shape[0])
        if plen >= self.max_len:
            raise ValueError(
                f"prompt of {plen} tokens does not fit max_len="
                f"{self.max_len} (slot cache holds prompt + generated "
                "tokens); reject or shed it upstream")
        if req.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {req.max_new_tokens}")
        rec = RECENT if self.tracer is None else self.tracer
        t0 = time.perf_counter()
        with scope(rec, self.tracer is not None, rid=req.rid):
            with span("engine.prefill.launch"):
                prompt = req.prompt.to(self.device, torch.int64)
                logits = self._prefill_one(prompt, slot)
            t1 = time.perf_counter()
            with span("engine.prefill.sync"):
                with span("engine.sample"):
                    tok = sample(logits, self.generator, self.temperature)
                first = int(tok)
            t2 = req.first_token_at = time.perf_counter()
        rec.add("prefill_step", f"req{req.rid}", "engine", t0 - rec.origin,
                t2 - rec.origin, rid=req.rid, slot=slot, prompt_len=plen,
                launch_s=t1 - t0, sync_s=t2 - t1)
        self.n_prefills += 1
        self.prefill_s += t2 - t0
        req.out_tokens.append(first)
        if (len(req.out_tokens) >= req.max_new_tokens
                or (self.eos_id is not None and first == self.eos_id)):
            req.done = True
            return True
        self.slot_live[slot] = True
        self.live_mask[slot] = True
        self.slot_req[slot] = req
        self.slot_pos[slot] = plen
        self.last_tok[slot, 0] = first
        return True

    def step(self) -> int:
        """One batched decode step for all live slots. Returns #live."""
        if not any(self.slot_live):
            return 0
        rec = RECENT if self.tracer is None else self.tracer
        n = self.n_decode_steps + 1
        t0 = time.perf_counter()
        with scope(rec, self.tracer is not None, step=n):
            with span("engine.decode.launch"):
                self._decode_step()
            t1 = time.perf_counter()
            # ONE host sync per step: tokens and positions fetched together
            with span("engine.decode.sync"):
                toks, pos = torch.stack([self.last_tok[:, 0],
                                         self.slot_pos]).tolist()
            t2 = time.perf_counter()
        self.n_decode_steps += 1
        self.decode_s += t2 - t0
        rec.add("decode_step", f"step{n}", "engine", t0 - rec.origin,
                t2 - rec.origin, step=n, n_live=self.slot_live.count(True),
                launch_s=t1 - t0, sync_s=t2 - t1)
        for slot, req in enumerate(self.slot_req):
            if req is None or not self.slot_live[slot]:
                continue
            t = toks[slot]
            req.out_tokens.append(t)
            limit_hit = len(req.out_tokens) >= req.max_new_tokens
            eos_hit = self.eos_id is not None and t == self.eos_id
            if limit_hit or eos_hit or pos[slot] >= self.max_len - 1:
                req.done = True
                self.slot_live[slot] = False
                self.live_mask[slot] = False
                self.slot_req[slot] = None
        return sum(self.slot_live)

    def serve(self, requests: list[Request]) -> list[Request]:
        """Run a full workload: admit as slots free up, decode until done."""
        pending = list(requests)
        done: list[Request] = []
        inflight: list[Request] = []
        while pending or inflight:
            while pending and self.admit(pending[0]):
                inflight.append(pending.pop(0))
            self.step()
            for r in list(inflight):
                if r.done:
                    inflight.remove(r)
                    done.append(r)
        return done
