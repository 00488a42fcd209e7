"""Serving-gateway benchmark: continuous batching under Poisson traffic
(the port's twin of the repository's `benchmarks/gateway_bench.py`).

The "millions of users" number, measured and modeled through
`repro_torch.serve.gateway` (DESIGN.md §14). Six sections:

  1. Steady-state throughput (MEASURED wall clock): a seeded Poisson
     arrival stream through `Gateway` over the fused engine at a
     sustainable rate — sustained requests/s, p50/p99 TTFT and
     inter-token latency, goodput. On the CPU at REDUCED scale, as the
     reference runs it; on the card the full-width workload
     (`full_width_gateway`, which chip_smoke.py's phase 15 (a) drives
     too): granite-3-8b at full width and depth (bf16, 4 slots x 2048
     tokens, random weights from a seed), FULL_REQUESTS arrivals at
     FULL_LOAD of the rate that the warmed engine's measured admission
     and step times sustain, the whole plan-cache envelope prewarmed
     before traffic.
  2. Plan-cache amortization under batch-signature churn: a long
     deterministic run whose admissions/evictions churn the live-slot
     count and position buckets; ASSERTS >80% plan-cache hit rate at
     steady state and reports the planner solves amortized away.
  3. Overload and goodput: offered load far above capacity against a
     bounded queue with the shed policy — per-priority-class completion
     and rejection, goodput vs offered, interactive-vs-batch tail
     latency (the reject/shed policy at work).
  4. Budget/EOS admission gate: a budget-1 request produces EXACTLY one
     token on the fused AND dispatch engines, finished at admission
     with its slot never entering decode.
  5. Paper-scale projection (MODELED): decode/prefill DAGs priced at
     paper dims (4k d_model / 32 layers / 2556-DPU grid) through the
     same `PlanCache` keying, swept over batch sizes — modeled tokens/s,
     sustained requests/s, and requests/day (the "millions of users"
     statement, stated honestly as a cost-model projection of the
     modelled machines; it runs on the host).
  6. Dispatch-engine gateway + measured trace: the gateway drives the
     planner-routed engine with a tracer attached; the planner-fidelity
     gate replays the gateway-driven decode timeline (predicted
     `pipelined_s` within 10% of the replayed trace) and `--trace
     OUT_JSON` exports the trace plus its Chrome trace_event twin.

Sections 2-6 run at REDUCED scale on any device. `run(report,
quick=True)` (`python -m repro_torch.benchmarks.run gateway_bench
--quick`) keeps sections 2-4 and 6 at reduced request counts — the
acceptance asserts all still run.
"""

from __future__ import annotations

import dataclasses
import importlib
import tempfile
import time
from pathlib import Path

import torch

from ..configs import REDUCED, get_arch
from ..device import resolve_device
from ..dispatch import PlanCache, batch_signature, workloads
from ..dispatch import trace as dtrace
from ..dispatch.placement import plan as plan_placement
from ..dispatch.schedule import make_schedule
from ..models import init_params
from ..serve import (PRIORITIES, Gateway, ManualClock, Request,
                     ServeEngine, load_arrival_trace, percentile,
                     poisson_requests, save_arrival_trace)

SEED = 0
#: the full-width serving workload: section 1 on the card and
#: chip_smoke.py's phase 15 (a). granite-3-8b at full width and depth
#: (bf16, 4 slots x 2048 tokens, SEED weights); FULL_REQUESTS seeded
#: Poisson arrivals of FULL_NEW new tokens whose prompts take one of
#: FULL_PROMPT_LENS (phase 5's 64-1500), so the prefill envelope is five
#: plan solves; KV buckets of 512 positions make the decode envelope 4
#: live-slot counts x 4 buckets = 16 solves (the default 64 would be 128,
#: past PlanCache's default 64 entries: LRU would evict half the prewarm)
FULL_ARCH, FULL_SLOTS, FULL_MAX_LEN, FULL_POS_BUCKET = \
    "granite-3-8b", 4, 2048, 512
FULL_REQUESTS, FULL_NEW = 16, 32
FULL_PROMPT_LENS = (64, 400, 750, 1100, 1500)
#: arrivals at this share of what the engine sustains in the same
#: process: slots / (s an admission + (FULL_NEW - 1) s a decode step),
#: both measured on the warmed engine just before traffic
FULL_LOAD = 0.5
#: the goodput's SLOs: first token within 1 s, every next within 200 ms
FULL_SLO_TTFT_S, FULL_SLO_ITL_S = 1.0, 0.2


@dataclasses.dataclass
class FullWidth:
    """The full-width workload, warmed, measured and prewarmed: `run`
    it with `gateway.run(requests)` and hold the result to
    `check_full_width`."""
    cfg: object
    engine: ServeEngine
    gateway: Gateway
    requests: list
    admission_s: float      # mean s an admission, measured
    step_s: float           # mean s a decode step, measured
    sustain_rps: float      # slots / (admission_s + (FULL_NEW - 1) step_s)
    rate_rps: float         # FULL_LOAD x sustain_rps
    prewarm_s: float
    prewarm: dict           # the plan cache's stats after the prewarm


def full_width_requests(cfg, rate_rps: float, path,
                        prompt_lens=FULL_PROMPT_LENS,
                        n_requests: int = FULL_REQUESTS) -> list:
    """`n_requests` seeded Poisson arrivals at `rate_rps` with FULL_NEW
    new tokens each and prompts of `prompt_lens` (the length's index
    drawn as a "prompt length" of 1..len(prompt_lens) by
    `poisson_requests`), written with `save_arrival_trace` to `path` and
    read back with `load_arrival_trace` (which draws the tokens from
    SEED), so the trace file's path runs too."""
    shape = poisson_requests(
        n_requests, rate_rps, seed=SEED, prompt_lens=(1, len(prompt_lens)),
        max_new=(FULL_NEW, FULL_NEW), priorities=(1,), weights=(1,))
    for g in shape:
        g.prompt = torch.zeros(prompt_lens[len(g.prompt) - 1],
                               dtype=torch.int32)
    assert save_arrival_trace(path, shape) == len(shape), \
        "save_arrival_trace wrote a short trace"
    reqs = load_arrival_trace(path, seed=SEED, vocab=cfg.vocab_size)
    assert [(g.arrival_s, len(g.prompt), g.max_new_tokens) for g in reqs] \
        == [(g.arrival_s, len(g.prompt), g.max_new_tokens) for g in shape], \
        "the arrival trace did not round-trip"
    return reqs


def full_width_gateway(device, *, reduced: bool = False,
                       max_len: int = FULL_MAX_LEN,
                       prompt_lens=FULL_PROMPT_LENS,
                       pos_bucket: int = FULL_POS_BUCKET) -> FullWidth:
    """Build the full-width workload on `device` (`reduced`, a shorter
    `max_len`, other `prompt_lens` or `pos_bucket`: the same workload at
    a size the CPU runs). Warms the engine (one request per prompt length,
    so the kernels are built and the allocator has grown), then serves
    one request of FULL_NEW tokens per prompt length and reads the
    engine's mean admission and decode-step times off that pass; the
    arrival rate is FULL_LOAD of what those times sustain. Prewarms the
    whole plan-cache envelope (timed) and asserts it solved every
    signature once and evicted none."""
    cfg = get_arch(FULL_ARCH, reduced=reduced)
    params = init_params(SEED, cfg, device)
    eng = ServeEngine(cfg, params, batch_slots=FULL_SLOTS, max_len=max_len,
                      seed=SEED, device=device)

    def one_per_length(max_new):
        eng.serve([Request(-1 - i, torch.ones(n, dtype=torch.int32),
                           max_new) for i, n in enumerate(prompt_lens)])

    one_per_length(2)
    pre = (eng.prefill_s, eng.n_prefills, eng.decode_s, eng.n_decode_steps)
    one_per_length(FULL_NEW)
    admission_s = (eng.prefill_s - pre[0]) / (eng.n_prefills - pre[1])
    step_s = (eng.decode_s - pre[2]) / (eng.n_decode_steps - pre[3])
    sustain = eng.n_slots / (admission_s + (FULL_NEW - 1) * step_s)
    rate = FULL_LOAD * sustain
    with tempfile.TemporaryDirectory() as tmp:
        reqs = full_width_requests(cfg, rate, Path(tmp) / "arrivals.jsonl",
                                   prompt_lens)
    gw = Gateway(eng, queue_capacity=len(reqs) + 1, pos_bucket=pos_bucket,
                 slo_ttft_s=FULL_SLO_TTFT_S, slo_itl_s=FULL_SLO_ITL_S)
    # prewarm the plan cache out of band: a cold DAG build and solve at
    # full width costs a second or more, and an in-band miss would stall
    # every live slot's next token
    t0 = time.perf_counter()
    warm = dict(gw.prewarm(prompt_lens=prompt_lens))
    prewarm_s = time.perf_counter() - t0
    want = eng.n_slots * -(-max_len // pos_bucket) + len(set(prompt_lens))
    assert warm["misses"] == want and not warm["evictions"], \
        f"prewarm solved {warm}, want {want} solves and no eviction"
    return FullWidth(cfg, eng, gw, reqs, admission_s, step_s, sustain, rate,
                     prewarm_s, warm)


def check_full_width(fw: FullWidth, stats) -> None:
    """The full-width run's gates: every request done with FULL_NEW tokens
    in the vocabulary, and no plan solved in band."""
    assert stats.completed == len(fw.requests), \
        f"{stats.completed} of {len(fw.requests)} requests done"
    assert stats.plan_cache["misses"] == fw.prewarm["misses"], \
        (f"the prewarmed run solved "
         f"{stats.plan_cache['misses'] - fw.prewarm['misses']} plans in band")
    for g in fw.gateway.finished:
        assert len(g.out_tokens) == FULL_NEW and all(
            0 <= t < fw.cfg.vocab_size for t in g.out_tokens), \
            f"request {g.rid}: tokens {g.out_tokens}"


def _setup(device, cfg_name="granite-3-8b"):
    cfg = REDUCED[cfg_name]
    return cfg, init_params(SEED, cfg, device)


def _class_rows(gw):
    """Per-priority-class outcome rows for one finished gateway."""
    rows = []
    for p, name in enumerate(PRIORITIES):
        done = [g for g in gw.finished if g.priority == p]
        rej = [g for g in gw.rejected if g.priority == p]
        ttfts = sorted(g.ttft_s for g in done if g.ttft_s is not None)
        rows.append({"class": name, "completed": len(done),
                     "rejected": len(rej),
                     "shed": sum(1 for g in rej
                                 if g.reject_reason == "shed"),
                     "TTFT p50 ms":
                         round(percentile(ttfts, 50) * 1e3, 2),
                     "TTFT p99 ms":
                         round(percentile(ttfts, 99) * 1e3, 2)})
    return rows


def _steady_state(report, device, n_requests):
    """Section 1: measured wall-clock serving under seeded Poisson; on the
    card the full-width workload (`full_width_gateway`)."""
    if device.type == "cuda":
        report.section("Steady-state serving under seeded Poisson "
                       "(granite-3-8b full width, bf16, measured wall "
                       "clock)")
        fw = full_width_gateway(device)
        report.note(f"plan-cache prewarm: {fw.prewarm['misses']} signature "
                    f"solves in {fw.prewarm_s:.1f}s before traffic; "
                    f"arrivals at {fw.rate_rps:.3f} req/s ({FULL_LOAD} x "
                    f"{fw.sustain_rps:.3f}: {fw.admission_s * 1e3:.1f} ms "
                    f"an admission, {fw.step_s * 1e3:.2f} ms a step)")
        stats = fw.gateway.run(fw.requests)
        report.table([dict((k, v) for k, v in stats.rows())])
        check_full_width(fw, stats)
        eng = fw.engine
    else:
        report.section("Steady-state serving under seeded Poisson "
                       "(reduced scale, measured wall clock)")
        cfg, params = _setup(device)
        eng = ServeEngine(cfg, params, batch_slots=4, max_len=64,
                          device=device)
        # warm the path — one request per distinct prompt length in the
        # sweep — so the measured run prices steady-state serving, not
        # the first trace or the allocator's first growth
        for i, plen in enumerate(range(4, 9)):
            eng.serve([Request(-1 - i, torch.ones((plen,), dtype=torch.int32),
                               2)])
        gw = Gateway(eng, queue_capacity=n_requests + 1, pos_bucket=16,
                     slo_ttft_s=0.5, slo_itl_s=0.25)
        # prewarm the plan cache out of band (a cold DAG build and solve
        # costs 100s of ms — in-band misses would stall every live
        # slot's next token)
        t0 = time.perf_counter()
        warm = gw.prewarm(range(4, 9))
        report.note(f"plan-cache prewarm: {warm['misses']} signature "
                    f"solves in {time.perf_counter() - t0:.1f}s before "
                    "traffic")
        reqs = poisson_requests(n_requests, 8.0, seed=7,
                                vocab=cfg.vocab_size, prompt_lens=(4, 8),
                                max_new=(4, 10))
        stats = gw.run(reqs)
        report.table([dict((k, v) for k, v in stats.rows())])
        assert stats.completed == n_requests, "steady-state run dropped work"
        assert stats.plan_cache["misses"] == warm["misses"], \
            "the prewarmed run solved a plan in band"
    report.note(f"fused engine, {eng.n_slots} slots: "
                f"{stats.sustained_rps:.2f} sustained req/s at p99 TTFT "
                f"{stats.ttft_p99_s * 1e3:.1f}ms / p99 ITL "
                f"{stats.itl_p99_s * 1e3:.1f}ms ({device} wall clock; "
                "paper-scale projection in the modeled section)")
    return stats


def _churn_sweep(report, cfg, params, n_requests, device):
    """Section 2: the plan-cache hit-rate gate under signature churn."""
    report.section("Plan-cache amortization under batch-signature churn")
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=64, device=device)
    gw = Gateway(eng, queue_capacity=n_requests + 1, pos_bucket=8,
                 clock=ManualClock(tick=1e-4))
    reqs = poisson_requests(n_requests, 100.0, seed=11,
                            vocab=cfg.vocab_size, prompt_lens=(3, 10),
                            max_new=(2, 12))
    stats = gw.run(reqs)
    pc = stats.plan_cache
    report.table([{"requests": stats.completed, "steps": stats.steps,
                   "planner calls": pc["calls"], "hits": pc["hits"],
                   "solves (misses)": pc["misses"],
                   "hit rate": f"{pc['hit_rate']:.1%}"}])
    # acceptance: >80% of planner consults served from cache at
    # steady state even though every admission/eviction and every
    # position-bucket crossing changes the batch signature
    assert pc["hit_rate"] > 0.80, \
        f"plan-cache hit rate {pc['hit_rate']:.1%} <= 80% on churn sweep"
    report.note(f"pos_bucket=8 over a 4-slot engine: {pc['misses']} "
                f"planner solves serve {pc['calls']} consults — "
                "replanning amortizes exactly like FaceCache compiles")
    return stats


def _overload(report, cfg, params, n_requests, device):
    """Section 3: bounded queue + shed policy under 5x overload."""
    report.section("Overload: bounded queue, shed policy, goodput")
    eng = ServeEngine(cfg, params, batch_slots=1, max_len=64, device=device)
    gw = Gateway(eng, queue_capacity=3, shed_policy="shed",
                 pos_bucket=16, clock=ManualClock(tick=2e-3),
                 slo_ttft_s=0.15)
    reqs = poisson_requests(n_requests, 2000.0, seed=13,
                            vocab=cfg.vocab_size, prompt_lens=(4, 8),
                            max_new=(4, 8))
    stats = gw.run(reqs)
    report.table([dict((k, v) for k, v in stats.rows())])
    report.table(_class_rows(gw))
    assert stats.rejected > 0, "overload run never rejected"
    assert stats.completed + stats.rejected == stats.offered
    report.note("a near-simultaneous burst against one slot and a "
                "3-deep queue: the bounded queue sheds lowest-priority "
                "work, goodput counts only requests that met the 150ms "
                "TTFT SLO")
    return stats


def _budget_gate(report, cfg, params, dis_eng, device):
    """Section 4: budget-1 yields exactly 1 token on both engines."""
    report.section("Budget/EOS admission gate (budget-1 == 1 token)")
    rows = []
    jit_eng = ServeEngine(cfg, params, batch_slots=2, max_len=48,
                          device=device)
    for engine, eng in (("jit", jit_eng), ("dispatch", dis_eng)):
        req = Request(0, torch.tensor([3, 1, 4, 1, 5], dtype=torch.int32),
                      max_new_tokens=1)
        assert eng.admit(req), "free engine refused admission"
        # acceptance: exactly one token, finished at admit, the
        # slot never entered decode
        assert req.done and len(req.out_tokens) == 1, \
            f"{engine}: budget-1 produced {len(req.out_tokens)} tokens"
        assert eng.n_free == 2, f"{engine}: budget-1 held a slot"
        rows.append({"engine": engine, "tokens": len(req.out_tokens),
                     "done at admit": req.done,
                     "slot freed": eng.n_free == 2})
    report.table(rows)


def _paper_projection(report):
    """Section 5: the modeled 'millions of users' statement."""
    report.section("Paper-scale projection (modeled, 2556-DPU grid)")
    cache = PlanCache()
    base = workloads.DecodeDims()          # 4k d_model / 32 layers
    avg_new, prompt_len, chunk = 256, 2048, 512

    def price_decode(nb):
        key = batch_signature(nb, (base.seq - 1,), pos_bucket=256)
        def build():
            dims = dataclasses.replace(base, batch=nb)
            dag = workloads.decode_dag(dims)
            p = plan_placement(dag)
            return make_schedule(dag, p, pipelined=True).pipelined_s
        return cache.get_or_plan(key, build)

    splits = workloads.prefill_chunk_splits(prompt_len, chunk)
    pkey = batch_signature(1, splits=splits, phase="prefill")
    def build_prefill():
        dag = workloads.prefill_dag(base, prefill_len=prompt_len,
                                    chunk=chunk, batch=1)
        p = plan_placement(dag, objective="overlapped")
        return make_schedule(dag, p, pipelined=True).pipelined_s
    prefill_s = cache.get_or_plan(pkey, build_prefill)

    fleet_ranks = 256
    rows = []
    best_daily = 0.0
    for nb in (1, 8, 32, 64):
        step_s = price_decode(nb)
        tok_s = nb / step_s
        # depth-first admission: a request costs its prefill plus
        # avg_new decode-step shares of the batch
        req_s = nb / (avg_new * step_s + prefill_s)
        daily = req_s * 86_400
        best_daily = max(best_daily, daily)
        rows.append({"batch slots": nb,
                     "decode step ms": round(step_s * 1e3, 1),
                     "tokens/s": round(tok_s, 1),
                     "req/s (256 new, 2k prompt)": round(req_s, 3),
                     "req/day/rank": f"{daily:,.0f}",
                     f"req/day x{fleet_ranks} ranks":
                         f"{daily * fleet_ranks:,.0f}"})
    report.table(rows)
    # the "millions of users" statement, stated honestly: one
    # host+2556-DPU rank serves thousands of long-form requests/day
    # (the un-quantized host GEMVs dominate the modeled step — the KT2
    # quantization item on the ROADMAP is what lifts this); a
    # 256-rank fleet clears a million requests/day
    assert best_daily * fleet_ranks > 1e6, \
        "paper-scale fleet projection under 1M req/day"

    # the x256 column above is the NAIVE multiplier — 256
    # independent ranks, each with a dedicated full-bandwidth host
    # channel. The honest fleet packs ranks 4-per-host (the Topology
    # model's rank-parallel channels): each rank keeps its own transfer
    # channel, but the pod's concurrent streams divide the host's DRAM
    # fabric, so each rank's decode/prefill timeline is REPLAYED under a
    # what-if system with 1/ranks_per_host of the channel bandwidth
    # (`trace.replay.what_if`) and the fleet is re-priced from that
    # modeled multi-rank throughput. Both numbers are reported.
    rp = importlib.import_module("..dispatch.trace.replay", __package__)
    ranks_per_host = 4
    wi = rp.what_if(channel_scale=1.0 / ranks_per_host)
    nb = 64
    dims = dataclasses.replace(base, batch=nb)
    dag = workloads.decode_dag(dims)
    p = plan_placement(dag)
    dstep_s = rp.replay(rp.modeled_trace(dag, p), dag, p.assignment,
                        dpu=wi).total_s
    pdag = workloads.prefill_dag(base, prefill_len=prompt_len,
                                 chunk=chunk, batch=1)
    pp = plan_placement(pdag, objective="overlapped")
    pstep_s = rp.replay(rp.modeled_trace(pdag, pp), pdag, pp.assignment,
                        dpu=wi).total_s
    rank_req_s = nb / (avg_new * dstep_s + pstep_s)
    fleet_daily = rank_req_s * fleet_ranks * 86_400
    naive_daily = best_daily * fleet_ranks
    # stress row: all 256 ranks on ONE host fabric — where the dedicated-
    # channel assumption finally breaks and transfers surface past compute
    stress_s = rp.replay(rp.modeled_trace(dag, p), dag, p.assignment,
                         dpu=rp.what_if(
                             channel_scale=1.0 / fleet_ranks)).total_s
    stress_daily = (nb / (avg_new * stress_s + pstep_s)) \
        * fleet_ranks * 86_400
    report.table([
        {"fleet model": f"naive x{fleet_ranks} (dedicated channels)",
         "decode step ms": round(price_decode(nb) * 1e3, 1),
         "req/day fleet": f"{naive_daily:,.0f}",
         "vs naive": "1.00x"},
        {"fleet model": (f"{fleet_ranks // ranks_per_host} hosts x "
                         f"{ranks_per_host} ranks (what-if replay, "
                         f"channels /{ranks_per_host})"),
         "decode step ms": round(dstep_s * 1e3, 1),
         "req/day fleet": f"{fleet_daily:,.0f}",
         "vs naive": f"{fleet_daily / naive_daily:.2f}x"},
        {"fleet model": (f"stress: {fleet_ranks} ranks, one fabric "
                         f"(channels /{fleet_ranks})"),
         "decode step ms": round(stress_s * 1e3, 1),
         "req/day fleet": f"{stress_daily:,.0f}",
         "vs naive": f"{stress_daily / naive_daily:.2f}x"},
    ])
    assert fleet_daily > 1e6, \
        "modeled multi-rank fleet projection under 1M req/day"
    assert fleet_daily <= naive_daily * (1 + 1e-9) and \
        stress_daily <= fleet_daily * (1 + 1e-9), \
        "channel contention cannot beat dedicated channels"
    report.note(f"modeled hybrid plans (planner ladder, seconds): one "
                f"2556-DPU rank sustains ~{best_daily:,.0f} long-form "
                f"requests/day at 64 slots; the re-priced "
                f"{fleet_ranks}-rank fleet (pods of {ranks_per_host} "
                "ranks sharing a host fabric, per-rank timelines "
                "replayed under the contended what-if channels) "
                f"clears ~{fleet_daily / 1e6:.1f}M requests/day — "
                "millions of daily users at ~1 request each. The "
                "pod-contended replay matches the dedicated-channel "
                "step: the dense decode timeline is host-GEMV-bound "
                "(KT2) and its transfers stay hidden under compute even "
                f"at 1/{ranks_per_host} bandwidth — the stress row "
                "shows channel contention only surfaces when the whole "
                "fleet shares one fabric. Projection only (no UPMEM "
                "hardware here); the same cost model the fidelity gate "
                "pins within 10% of replayed traces at reduced scale. "
                "The quantized MoE projection below is the int8 "
                "expert/KV lever that shrinks the host-bound step")

    # the KT2 flip through the same PlanCache keying: the quantized MoE
    # serving step (int8 expert GEMMs on the DPU 8x8-multiplier band,
    # int8 KV) vs its f32 twin at mixtral-8x7b dims — the sustained-req/s
    # delta the int8 flip buys a serving rank
    report.section("Quantized MoE projection (int8 experts + int8 KV "
                   "vs f32, mixtral-8x7b dims)")
    moe32 = workloads.MOE_PAPER_DIMS
    moe8 = workloads.MOE_PAPER_DIMS_INT8

    def price_moe_decode(dims, nb, tag):
        key = batch_signature(nb, (dims.seq - 1,), pos_bucket=256,
                              phase=f"moe-decode-{tag}")
        def build():
            dd = dataclasses.replace(dims, batch=nb)
            dag = workloads.moe_decode_dag(dd)
            p = plan_placement(dag)
            return make_schedule(dag, p, pipelined=True).pipelined_s
        return cache.get_or_plan(key, build)

    def price_moe_prefill(dims, tag):
        key = batch_signature(1, splits=splits, phase=f"moe-prefill-{tag}")
        def build():
            dag = workloads.prefill_dag(dims, prefill_len=prompt_len,
                                        chunk=chunk, batch=1)
            p = plan_placement(dag, objective="overlapped")
            return make_schedule(dag, p, pipelined=True).pipelined_s
        return cache.get_or_plan(key, build)

    pf32 = price_moe_prefill(moe32, "f32")
    pf8 = price_moe_prefill(moe8, "int8")
    rows = []
    for nb in (8, 32):
        s32 = price_moe_decode(moe32, nb, "f32")
        s8 = price_moe_decode(moe8, nb, "int8")
        r32 = nb / (avg_new * s32 + pf32)
        r8 = nb / (avg_new * s8 + pf8)
        # acceptance: the quantized configuration sustains
        # strictly more requests/s at every projected batch size
        assert r8 > r32, \
            f"int8 MoE projection no faster than f32 at batch {nb}"
        rows.append({"batch slots": nb,
                     "f32 step ms": round(s32 * 1e3, 1),
                     "int8 step ms": round(s8 * 1e3, 1),
                     "f32 req/s": round(r32, 3),
                     "int8 req/s": round(r8, 3),
                     "sustained req/s delta":
                         f"+{(r8 / r32 - 1) * 100:.0f}%"})
    report.table(rows)
    report.note("the KT2 flip in serving terms: int8 expert FFNs plan "
                "onto the DPU grid (2-cycle native 8x8 muls) and the "
                "int8 KV cache quarters the bank-resident attention "
                "stream, so each decode step shrinks and the same rank "
                "sustains the req/s delta above at identical batch "
                "shapes")


def _dispatch_trace(report, cfg, eng, n_requests, trace_out):
    """Section 6: gateway-driven dispatch engine, fidelity-gated trace."""
    report.section("Dispatch-engine gateway, measured trace + "
                   "fidelity gate")
    tracer = dtrace.Trace("gateway-dispatch",
                          meta={"engine": "dispatch", "slots": 2})
    gw = Gateway(eng, queue_capacity=n_requests + 1, pos_bucket=16,
                 clock=ManualClock(tick=1e-3))
    gw.attach_tracer(tracer)
    reqs = poisson_requests(n_requests, 100.0, seed=17,
                            vocab=cfg.vocab_size, prompt_lens=(3, 8),
                            max_new=(3, 6))
    stats = gw.run(reqs)
    rep = dtrace.fidelity(eng._dispatch_decode.dag, eng._dispatch_decode.plan,
                          trace=tracer)
    report.table([{"requests": stats.completed, "steps": stats.steps,
                   "decode spans": len(tracer.by_kind("decode_step")),
                   "prefill spans": len(tracer.by_kind("prefill_step")),
                   "executor-cache hit rate":
                       f"{eng._dispatch_prefill.executor_cache.stats['hit_rate']:.1%}",
                   "fidelity err %": round(rep.rel_err * 100.0, 2)}])
    # the planner-fidelity gate on a GATEWAY-driven timeline: predicted
    # pipelined_s within 10% of the replayed measured trace
    assert rep.ok, rep.render()
    if trace_out:
        tracer.save(trace_out)
        chrome = trace_out.replace(".json", "") + ".chrome.json"
        tracer.save_chrome(chrome)
        report.note(f"gateway trace -> {trace_out} (+ Chrome twin "
                    f"{chrome})")
    report.note(rep.render())


def run(report, quick: bool = False, trace_out: str | None = None,
        device=None):
    """Drive the gateway sweeps on `device` (None: the card); `quick`
    keeps sections 2-4 and 6 at reduced request counts, full mode adds
    the measured steady-state section and the paper-scale projection."""
    device = resolve_device(device)
    if not quick:
        _steady_state(report, device, n_requests=24)
    cfg, params = _setup(device)
    _churn_sweep(report, cfg, params, n_requests=10 if quick else 40,
                 device=device)
    _overload(report, cfg, params, n_requests=8 if quick else 30,
              device=device)
    # one dispatch engine shared by the budget gate and the traced run
    dis_eng = ServeEngine(cfg, params, batch_slots=2, max_len=48,
                          device=device, engine="dispatch",
                          dispatch_kwargs={"prefill_chunk": 4})
    _budget_gate(report, cfg, params, dis_eng, device)
    if not quick:
        _paper_projection(report)
    _dispatch_trace(report, cfg, dis_eng,
                    n_requests=3 if quick else 6, trace_out=trace_out)
