"""Serving gateway: admission control and SLO-aware scheduling above the
slot loop — continuous batching under arrivals.

Counterpart of `repro.serve.gateway`, with the same names and control
flow. `ServeEngine` owns slots; its `serve()` admits FIFO with an
unbounded backlog, no priorities, and no notion of how much decode
stall an admission's prefill injects. `Gateway` is that layer
(DESIGN.md §14):

  * **Admission queue** — bounded, priority-classed (`PRIORITIES`:
    interactive < standard < batch). A full queue rejects the arrival
    (policy `"reject"`) or sheds the lowest-priority queued request in
    favor of a strictly higher-priority one (policy `"shed"`); prompts
    the slot cache cannot hold are rejected up front (the engine would
    raise `ValueError`).
  * **Plan cache** — planner products keyed by *batch signature*
    (`dispatch.plan_cache.batch_signature`: live-slot count, bucketed
    KV length, chunk splits, channel-topology shape). The gateway prices
    every decode step and every candidate admission through one
    `PlanCache`, so planner solves amortize as slot composition churns;
    `prewarm` solves the whole envelope before traffic.
  * **SLO-aware interleaving** — each admission's prefill stalls every
    live slot's next decode token (depth-first prefill), so the gap
    between two decode steps spends a *stall budget*: `max_stall_s`
    when set, else `stall_factor` x the modeled decode-step seconds
    (both sides priced by the plan cache). At least one admission per
    gap always proceeds when a slot is free (no starvation), and with
    no live decode there is nothing to stall, so draining is
    budget-free.

The prices are the port planner's own (`dispatch.workloads` graphs built
on the port's census), in modelled seconds of the planner's machines,
not the card's. All wall-clock timestamps come from the injected `clock`
(seconds; `time.perf_counter` by default — `ManualClock` makes runs
fully deterministic for tests and replays: it advances on every read,
so the gateway reads it exactly where the reference does). `GatewayStats`
aggregates sustained requests/s, p50/p99 TTFT and inter-token latency,
and goodput (requests/s that met their SLOs) — the numbers
`repro_torch.benchmarks.gateway_bench` reports under seeded Poisson
arrivals. Prompts are CPU integer tensors; `poisson_requests` and
`load_arrival_trace` draw them from `random.Random(seed)` draw for draw
as the reference does, so both packages make the same workload.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import math
import random
import time
from collections import deque
from typing import Callable, Sequence

import torch

from ..dispatch import workloads
from ..dispatch.placement import Plan, plan as plan_placement
from ..dispatch.plan_cache import PlanCache, batch_signature
from ..dispatch.schedule import make_schedule
from .dispatch_engine import dims_for_config
from .engine import Request, ServeEngine

#: priority classes, best first: index into this tuple is the `priority`
#: field — lower admits first (FIFO within a class)
PRIORITIES = ("interactive", "standard", "batch")


def percentile(sorted_vals: Sequence[float], pct: float) -> float:
    """Nearest-rank percentile of an ascending sequence (seconds in all
    gateway uses); 0.0 for an empty sequence."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, math.ceil(pct / 100.0 * len(sorted_vals)) - 1))
    return float(sorted_vals[i])


@dataclasses.dataclass
class GatewayRequest:
    """One gateway-scheduled request: the engine-facing payload (prompt,
    token budget) plus its priority class, arrival time, and the latency
    milestones the gateway records. All timestamps are clock seconds;
    `priority` indexes `PRIORITIES` (lower admits first). `arrival_s` is
    an offset from the run start when built by `poisson_requests` and is
    rebased to absolute clock time by `Gateway.run`."""
    rid: int
    prompt: torch.Tensor           # (S,) int32, on the CPU
    max_new_tokens: int
    priority: int = 1
    arrival_s: float = 0.0
    state: str = "created"         # created|queued|running|done|rejected
    reject_reason: str | None = None
    admit_s: float | None = None
    finish_s: float | None = None
    token_times: list[float] = dataclasses.field(default_factory=list)
    request: Request | None = None  # engine-side twin, set at admission

    @property
    def ttft_s(self) -> float | None:
        """Time to first token in seconds — first sampled token's clock
        time minus arrival (None before the first token)."""
        if not self.token_times:
            return None
        return self.token_times[0] - self.arrival_s

    @property
    def itl_s(self) -> list[float]:
        """Inter-token latencies in seconds between consecutive generated
        tokens (empty for single-token outputs)."""
        return [b - a for a, b in zip(self.token_times,
                                      self.token_times[1:])]

    @property
    def out_tokens(self) -> list[int]:
        """Generated token ids (the engine `Request`'s output; empty
        before admission)."""
        return list(self.request.out_tokens) if self.request else []


class AdmissionQueue:
    """Bounded priority admission queue: pop order is (priority class,
    arrival order) — FIFO within a class. `offer` applies the admission
    policy at capacity: `"reject"` refuses the arrival, `"shed"` evicts
    the worst queued request (lowest class, newest within it) when the
    arrival's class is strictly better."""

    def __init__(self, capacity: int, policy: str = "reject"):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if policy not in ("reject", "shed"):
            raise ValueError(f"policy must be 'reject' or 'shed', "
                             f"got {policy!r}")
        self.capacity = capacity
        self.policy = policy
        self._heap: list[tuple[int, int, GatewayRequest]] = []
        self._seq = 0

    def __len__(self) -> int:
        """Number of queued requests (<= capacity)."""
        return len(self._heap)

    def offer(self, greq: GatewayRequest
              ) -> tuple[bool, GatewayRequest | None]:
        """Try to enqueue `greq`: returns `(accepted, shed)` where `shed`
        is the lower-priority request evicted to make room (policy
        `"shed"` only), else None. Neither the rejected arrival nor the
        shed victim is state-marked here — the gateway records the
        decision."""
        if len(self._heap) < self.capacity:
            self._push(greq)
            return True, None
        if self.policy == "shed":
            worst_i = max(range(len(self._heap)),
                          key=lambda i: self._heap[i][:2])
            if self._heap[worst_i][0] > greq.priority:
                shed = self._heap.pop(worst_i)[2]
                heapq.heapify(self._heap)
                self._push(greq)
                return True, shed
        return False, None

    def _push(self, greq: GatewayRequest) -> None:
        heapq.heappush(self._heap, (greq.priority, self._seq, greq))
        self._seq += 1

    def peek(self) -> GatewayRequest | None:
        """The request `pop` would return next, without removing it."""
        return self._heap[0][2] if self._heap else None

    def pop(self) -> GatewayRequest | None:
        """Remove and return the best queued request (lowest priority
        class, earliest arrival within it), or None when empty."""
        return heapq.heappop(self._heap)[2] if self._heap else None


class ManualClock:
    """Deterministic virtual clock for tests and replayable runs:
    calling it returns the current time in seconds and advances it by
    `tick`, so a run's timestamps are a pure function of the call
    sequence — two seeded-Poisson gateway runs with equal ManualClocks
    produce identical traces. `advance_to` jumps forward over idle
    waits instead of sleeping."""

    def __init__(self, tick: float = 0.0, start: float = 0.0):
        self.t = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        """Current time in seconds; each read advances the clock by
        `tick`."""
        now = self.t
        self.t += self.tick
        return now

    def advance_to(self, t: float) -> None:
        """Jump the clock forward to `t` seconds (no-op if already
        past)."""
        self.t = max(self.t, float(t))


@dataclasses.dataclass(frozen=True)
class PricedPlan:
    """One plan-cache entry: the planned operator DAG, the placement the
    planner chose for it, and the modeled pipelined wall-clock in
    SECONDS of executing it — the currency the gateway's stall budget
    and paper-scale projections are denominated in."""
    graph: object                  # dispatch.OpGraph
    plan: Plan
    priced_s: float


@dataclasses.dataclass
class GatewayStats:
    """One gateway run's aggregate serving metrics. All times are
    seconds; rates are requests/s. `sustained_rps` counts completed
    requests over the run duration; `goodput_rps` counts only those that
    met the configured SLOs (equal to `sustained_rps` when no SLO is
    set). TTFT / inter-token percentiles are nearest-rank over completed
    requests; `plan_cache` is the gateway `PlanCache.stats` dict."""
    offered: int
    completed: int
    rejected: int
    shed: int
    tokens: int
    steps: int
    duration_s: float
    sustained_rps: float
    goodput_rps: float
    ttft_p50_s: float
    ttft_p99_s: float
    itl_p50_s: float
    itl_p99_s: float
    plan_cache: dict

    def rows(self) -> list[tuple[str, str]]:
        """(metric, value) rows for report tables — times rendered in
        milliseconds, rates in requests/s."""
        return [
            ("completed / offered",
             f"{self.completed}/{self.offered}"),
            ("rejected (shed)", f"{self.rejected} ({self.shed})"),
            ("tokens", str(self.tokens)),
            ("decode steps", str(self.steps)),
            ("duration", f"{self.duration_s:.3f} s"),
            ("sustained req/s", f"{self.sustained_rps:.2f}"),
            ("goodput req/s", f"{self.goodput_rps:.2f}"),
            ("TTFT p50 / p99",
             f"{self.ttft_p50_s * 1e3:.1f} / {self.ttft_p99_s * 1e3:.1f} ms"),
            ("ITL p50 / p99",
             f"{self.itl_p50_s * 1e3:.1f} / {self.itl_p99_s * 1e3:.1f} ms"),
            ("plan-cache hit rate",
             f"{self.plan_cache['hit_rate']:.2%} "
             f"({self.plan_cache['hits']}/{self.plan_cache['calls']})"),
        ]


class Gateway:
    """Admission-control and scheduling layer above one `ServeEngine`.

    `submit` applies admission control (prompt validation + the bounded
    priority queue), `step` runs one batched decode step and records
    per-request token times, and `run` drives a full arrival-stamped
    workload to completion. Admissions between decode steps are capped
    by the stall budget (see module docstring); every planner price the
    gateway consults flows through its `PlanCache`, keyed by
    `batch_signature`. All times are seconds from the injected `clock`;
    all modeled prices are seconds from the dispatch cost model."""

    def __init__(self, engine: ServeEngine, *, queue_capacity: int = 64,
                 shed_policy: str = "reject", pos_bucket: int = 64,
                 stall_factor: float = 4.0,
                 max_stall_s: float | None = None,
                 slo_ttft_s: float | None = None,
                 slo_itl_s: float | None = None,
                 plan_cache: PlanCache | None = None,
                 devices: tuple = ("xeon", "upmem_2556"),
                 kv_home: str = "upmem_2556",
                 clock: Callable[[], float] = time.perf_counter):
        self.engine = engine
        self.queue = AdmissionQueue(queue_capacity, shed_policy)
        self.plans = plan_cache if plan_cache is not None \
            else PlanCache(maxsize=64)
        self.pos_bucket = pos_bucket
        self.stall_factor = stall_factor
        self.max_stall_s = max_stall_s
        self.slo_ttft_s = slo_ttft_s
        self.slo_itl_s = slo_itl_s
        self.devices = tuple(devices)
        self.kv_home = kv_home
        self.clock = clock
        self._dims = dims_for_config(engine.cfg, engine.n_slots,
                                     engine.max_len)
        self.running: dict[int, GatewayRequest] = {}
        self.finished: list[GatewayRequest] = []
        self.rejected: list[GatewayRequest] = []
        self.submitted = 0
        self.steps = 0
        self.last_decode_price_s = 0.0
        self._t0: float | None = None
        self._t_end: float | None = None

    # ------------------------------------------------------------- #
    # plan-cache pricing
    # ------------------------------------------------------------- #
    def _positions(self) -> list[int]:
        """Python-side position estimate per running request (prompt
        length + tokens generated) — no device sync; feeds the decode
        batch signature."""
        return [int(g.request.prompt.shape[0]) + len(g.request.out_tokens)
                for g in self.running.values()]

    def decode_plan(self) -> PricedPlan:
        """The priced decode plan for the CURRENT batch signature
        (live-slot count + bucketed KV length), planned over the decode
        DAG through the plan cache — one planner solve per signature,
        shared until composition churns out of the bucket."""
        n_live = max(1, self.engine.n_slots - self.engine.n_free)
        key = batch_signature(n_live, self._positions(),
                              pos_bucket=self.pos_bucket,
                              topology=self.devices,
                              window=self._dims.window)
        return self.plans.get_or_plan(
            key, lambda: self._price_decode(n_live, key[2]))

    def _price_decode(self, n_live: int, kv_len: int) -> PricedPlan:
        dims = dataclasses.replace(self._dims, batch=n_live,
                                   seq=min(kv_len, self.engine.max_len))
        dag = workloads.decode_dag(dims, kv_home=self.kv_home)
        p = plan_placement(dag, devices=self.devices)
        sched = make_schedule(dag, p, pipelined=True)
        return PricedPlan(dag, p, float(sched.pipelined_s))

    def decode_price_s(self) -> float:
        """Modeled seconds of one decode step at the current batch
        signature — the denominator of the stall budget."""
        return self.decode_plan().priced_s

    def prefill_price_s(self, plen: int) -> float:
        """Modeled seconds of prefilling a `plen`-token prompt — the
        stall one admission charges against the budget. The chunked
        prefill DAG is keyed by its chunk splits
        (`ServeEngine.prefill_splits`) through the plan cache, so ragged
        prompts sharing a chunk grid share one planner solve."""
        splits = self.engine.prefill_splits(plen)
        key = batch_signature(1, splits=splits, phase="prefill",
                              pos_bucket=self.pos_bucket,
                              topology=self.devices,
                              window=self._dims.window)
        return self.plans.get_or_plan(
            key, lambda: self._price_prefill(splits)).priced_s

    def _price_prefill(self, splits: list[int]) -> PricedPlan:
        dims = dataclasses.replace(self._dims, batch=1)
        dag = workloads.prefill_dag(dims, prefill_len=sum(splits),
                                    chunk=splits[0], batch=1,
                                    kv_home=self.kv_home)
        p = plan_placement(dag, devices=self.devices)
        sched = make_schedule(dag, p, pipelined=True)
        return PricedPlan(dag, p, float(sched.pipelined_s))

    def prewarm(self, prompt_lens: Sequence[int] = ()) -> dict:
        """Price the expected signature envelope out of band, before
        taking traffic: every decode signature the engine can reach
        (live-slot count 1..n_slots x position buckets up to max_len)
        plus the prefill grids of `prompt_lens`. Building and costing a
        DAG dominates a cache miss (~100s of ms at reduced scale), so a
        cold miss inside the serving loop stalls every live slot's next
        token — production gateways warm first. Returns the plan
        cache's `stats` afterwards."""
        for n_live in range(1, self.engine.n_slots + 1):
            for hi in range(self.pos_bucket, self.engine.max_len +
                            self.pos_bucket, self.pos_bucket):
                key = batch_signature(n_live, (hi - 1,),
                                      pos_bucket=self.pos_bucket,
                                      topology=self.devices,
                                      window=self._dims.window)
                self.plans.get_or_plan(
                    key, lambda n=n_live, k=key[2]:
                        self._price_decode(n, k))
        for plen in prompt_lens:
            self.prefill_price_s(int(plen))
        return self.plans.stats

    # ------------------------------------------------------------- #
    # admission control
    # ------------------------------------------------------------- #
    def submit(self, greq: GatewayRequest) -> bool:
        """Admission control for one arrival: validate the payload
        against the engine (too-long prompts and empty budgets are
        rejected here — the engine would raise), then offer it to the
        bounded priority queue under the reject/shed policy. Returns
        True when queued; otherwise the request (or the shed victim)
        ends in state `"rejected"` with `reject_reason` set."""
        self.submitted += 1
        if int(greq.prompt.shape[0]) >= self.engine.max_len:
            self._reject(greq, "prompt-too-long")
            return False
        if greq.max_new_tokens < 1:
            self._reject(greq, "bad-budget")
            return False
        accepted, shed = self.queue.offer(greq)
        if shed is not None:
            self._reject(shed, "shed")
        if not accepted:
            self._reject(greq, "queue-full")
            return False
        greq.state = "queued"
        return True

    def _reject(self, greq: GatewayRequest, reason: str) -> None:
        greq.state = "rejected"
        greq.reject_reason = reason
        self.rejected.append(greq)

    def admit_pending(self) -> int:
        """Drain the queue into free slots in priority order under the
        stall budget; returns the number of admissions made. The budget
        caps the modeled prefill seconds one decode gap may inject:
        `max_stall_s` when set, else `stall_factor` x the modeled
        decode-step price — both sides priced by the plan cache. The
        first admission per gap always proceeds when a slot is free (no
        starvation), and with no live decode there is nothing to stall,
        so the budget only binds while decodes are in flight."""
        n = 0
        spent = 0.0
        while self.engine.n_free > 0 and len(self.queue) > 0:
            live = self.engine.n_slots - self.engine.n_free
            if live == 0:
                budget = math.inf
            elif self.max_stall_s is not None:
                budget = self.max_stall_s
            else:
                budget = self.stall_factor * self.decode_price_s()
            greq = self.queue.peek()
            price = self.prefill_price_s(int(greq.prompt.shape[0]))
            if n > 0 and spent + price > budget:
                break
            greq = self.queue.pop()
            req = Request(greq.rid, greq.prompt, greq.max_new_tokens)
            greq.request = req
            self.engine.admit(req)       # a slot is free: always True
            t = self.clock()
            greq.admit_s = t
            greq.state = "running"
            greq.token_times.append(t)   # first token sampled at admit
            spent += price
            n += 1
            if req.done:                 # budget/EOS met by first token
                self._finish(greq, t)
            else:
                self.running[greq.rid] = greq
        return n

    def _finish(self, greq: GatewayRequest, t: float) -> None:
        greq.state = "done"
        greq.finish_s = t
        self.finished.append(greq)

    # ------------------------------------------------------------- #
    # serving loop
    # ------------------------------------------------------------- #
    def step(self) -> int:
        """One batched decode step through the engine: prices the
        current signature through the plan cache (the per-step planner
        consult the cache amortizes), advances every live slot one
        token, records token times, and finalizes finished requests.
        Returns the number of live slots after the step."""
        if self.running:
            self.last_decode_price_s = self.decode_price_s()
        self.steps += 1
        live = self.engine.step()
        t = self.clock()
        for rid, greq in list(self.running.items()):
            req = greq.request
            if len(req.out_tokens) > len(greq.token_times):
                greq.token_times.append(t)
            if req.done:
                del self.running[rid]
                self._finish(greq, t)
        return live

    def run(self, requests: Sequence[GatewayRequest],
            max_steps: int | None = None) -> GatewayStats:
        """Drive a full arrival-stamped workload: feed each request at
        its `arrival_s` (an offset from the run start, rebased onto the
        clock), admit under the stall budget, decode until everything
        accepted has finished (or `max_steps` decode steps). When idle
        before the next arrival the gateway jumps a `ManualClock`
        forward (`advance_to`) or sleeps the wall clock. Returns the
        run's `GatewayStats`."""
        t0 = self.clock()
        if self._t0 is None:
            self._t0 = t0
        pending = deque(sorted(requests, key=lambda g: g.arrival_s))
        for g in pending:
            g.arrival_s += t0            # rebase offsets to clock time
        while pending or len(self.queue) > 0 or self.running:
            if max_steps is not None and self.steps >= max_steps:
                break
            now = self.clock()
            while pending and pending[0].arrival_s <= now:
                self.submit(pending.popleft())
            if not self.running and len(self.queue) == 0:
                if pending:              # idle until the next arrival
                    self._idle_until(pending[0].arrival_s)
                continue
            self.admit_pending()
            if self.engine.n_slots - self.engine.n_free > 0:
                self.step()
        self._t_end = self.clock()
        return self.stats()

    def _idle_until(self, t: float) -> None:
        if hasattr(self.clock, "advance_to"):
            self.clock.advance_to(t)
        else:
            time.sleep(max(0.0, min(t - self.clock(), 0.05)))

    # ------------------------------------------------------------- #
    # metrics
    # ------------------------------------------------------------- #
    def attach_tracer(self, tracer) -> None:
        """Attach a `dispatch.trace.Trace` to the underlying engine (see
        `ServeEngine.attach_tracer`): admissions record `prefill_step`
        spans and batched steps record `decode_step` spans — under the
        dispatch engine the per-stage compute spans too — the timeline
        `gateway_bench`'s fidelity gate replays. Pass None to detach."""
        self.engine.attach_tracer(tracer)

    def _met_slo(self, greq: GatewayRequest) -> bool:
        if self.slo_ttft_s is not None:
            if greq.ttft_s is None or greq.ttft_s > self.slo_ttft_s:
                return False
        if self.slo_itl_s is not None:
            if any(x > self.slo_itl_s for x in greq.itl_s):
                return False
        return True

    def stats(self) -> GatewayStats:
        """Aggregate `GatewayStats` over everything this gateway has
        finished or rejected so far (all times seconds; percentiles
        nearest-rank over completed requests)."""
        end = self._t_end if self._t_end is not None else self.clock()
        start = self._t0 if self._t0 is not None else end
        dur = max(end - start, 0.0)
        done = self.finished
        ttfts = sorted(g.ttft_s for g in done if g.ttft_s is not None)
        itls = sorted(x for g in done for x in g.itl_s)
        good = [g for g in done if self._met_slo(g)]
        shed = sum(1 for g in self.rejected if g.reject_reason == "shed")
        return GatewayStats(
            offered=self.submitted, completed=len(done),
            rejected=len(self.rejected), shed=shed,
            tokens=sum(len(g.out_tokens) for g in done),
            steps=self.steps, duration_s=dur,
            sustained_rps=(len(done) / dur) if dur > 0 else 0.0,
            goodput_rps=(len(good) / dur) if dur > 0 else 0.0,
            ttft_p50_s=percentile(ttfts, 50),
            ttft_p99_s=percentile(ttfts, 99),
            itl_p50_s=percentile(itls, 50),
            itl_p99_s=percentile(itls, 99),
            plan_cache=self.plans.stats)


def poisson_requests(n: int, rate_rps: float, *, seed: int = 0,
                     vocab: int = 128, prompt_lens: tuple = (4, 12),
                     max_new: tuple = (4, 12),
                     priorities: Sequence[int] = (0, 1, 2),
                     weights: Sequence[float] = (1, 2, 1),
                     start_s: float = 0.0) -> list[GatewayRequest]:
    """Seeded Poisson workload: `n` requests whose inter-arrival gaps are
    exponential with mean `1/rate_rps` seconds, prompt lengths and token
    budgets uniform over the given inclusive ranges, and priority
    classes drawn from `priorities` with `weights` — fully deterministic
    for one seed (`random.Random(seed)`), which is what the determinism
    test and the bench rely on. Arrival timestamps are seconds relative
    to the run start (`Gateway.run` rebases them onto its clock)."""
    rng = random.Random(seed)
    t = float(start_s)
    out = []
    for i in range(n):
        t += rng.expovariate(rate_rps)
        plen = rng.randint(*prompt_lens)
        prompt = torch.tensor([rng.randrange(vocab) for _ in range(plen)],
                              dtype=torch.int32)
        out.append(GatewayRequest(
            rid=i, prompt=prompt,
            max_new_tokens=rng.randint(*max_new),
            priority=rng.choices(list(priorities), list(weights))[0],
            arrival_s=t))
    return out


def save_arrival_trace(path, requests: Sequence[GatewayRequest]) -> int:
    """Write an arrival trace: one JSON record per line with the
    workload SHAPE of each request — `arrival_s` (seconds from run
    start), `prompt_len`, `max_new`, and the priority `class` name
    (`PRIORITIES`). Prompt token ids are deliberately not recorded: a
    trace captures traffic (what production logs give you), not
    content, and `load_arrival_trace` resynthesizes tokens from a seed.
    Returns the number of records written."""
    with open(path, "w") as f:
        for g in requests:
            f.write(json.dumps({
                "arrival_s": float(g.arrival_s),
                "prompt_len": int(g.prompt.shape[0]),
                "max_new": int(g.max_new_tokens),
                "class": PRIORITIES[g.priority]}) + "\n")
    return len(requests)


def load_arrival_trace(path, *, seed: int = 0,
                       vocab: int = 128) -> list[GatewayRequest]:
    """Load an arrival trace written by `save_arrival_trace` (or by
    hand: JSONL of `{"arrival_s", "prompt_len", "max_new", "class"}`,
    blank lines and `#` comments skipped; `class` is a `PRIORITIES`
    name or an integer index). Prompt tokens are drawn deterministically
    from `random.Random(seed)`, so one (trace, seed) pair replays the
    same workload byte-for-byte — the gateway determinism gate extended
    to file-based traffic. Requests are re-ridded 0..n-1 in file
    order."""
    rng = random.Random(seed)
    out: list[GatewayRequest] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rec = json.loads(line)
            cls = rec["class"]
            prompt = torch.tensor(
                [rng.randrange(vocab) for _ in range(int(rec["prompt_len"]))],
                dtype=torch.int32)
            out.append(GatewayRequest(
                rid=len(out), prompt=prompt,
                max_new_tokens=int(rec["max_new"]),
                priority=(PRIORITIES.index(cls) if isinstance(cls, str)
                          else int(cls)),
                arrival_s=float(rec["arrival_s"])))
    return out
