"""Offload planning benchmark: pure-CPU vs pure-PIM vs hybrid plans (the
port's twin of the repository's `benchmarks/dispatch_bench.py`).

Nine sweeps over `repro_torch.dispatch`, on the port's own graphs (built
on `core.census`) and planner. Every modelled second is the planner's
machines' (the Xeon, the Titan V, the UPMEM systems), none the card's:

  1. The 16 PrIM workloads at Fig.-4 granularity (one operator each):
     the planner's per-workload device pick vs the paper's suitability
     grouping — the hybrid (CPU+GPU+PIM) device choice recovers the
     group-2 workloads that pure PIM loses.
  2. The mixed PrIM pipeline (streaming -> transpose/rotate -> streaming):
     the DP plan beats BOTH pure placements by running the streams
     bank-parallel and handing the reorganization to the host.
  3. The LM decode step (serve.engine's workload) at paper scale: weight
     GEMVs on the host (float mul is a software routine on DPUs, KT2),
     quantized KV-cache attention bank-parallel (streaming int dots, KT1).
  4. The decode DAG (residual branches kept, KV-residency charged): the
     exact frontier-DP plan must beat both steelmanned pure baselines
     (pure CPU gets KV homed on the host) — the acceptance gate.
  5. The chunked prefill DAG (4 chunks at paper scale): serial- vs
     overlapped-objective plans, and the cross-phase residency trade —
     keeping the cache bank-resident for decode costs prefill only the
     KV write-back traffic. The same sweep prices the OLD
     serial chunk loop (chunk-major order, groups strictly serialized)
     against the unified executor's pipelined timeline
     (`Schedule.pipelined_s`) and asserts the pipelined discipline
     strictly beats the loop's throughput at paper scale.
  6. The MoE decode DAG at paper scale (mixtral-8x7b dims: 8 experts
     top-2, routed ladder per layer with token/combine EXCHANGE edges):
     the hybrid plan must strictly beat steelmanned pure CPU (KV
     re-homed to the host) and pure PIM (KV at home, but float expert
     GEMMs + two host-relayed all-to-alls per layer — the shape the
     architecture is worst at, KT3) — the acceptance gate.
  7. The QUANTIZED MoE decode DAG (int8 experts + int8 KV): the KT2
     flip — every expert FFN plans onto the DPU grid and the quantized
     hybrid strictly beats the f32 hybrid.
  8. Multi-rank scale-out: the 4-rank expert-parallel plan of
     the quantized mixtral DAG (expert shards rotated over
     rank-qualified devices, one transfer channel per rank) must
     strictly beat the SAME sharded plan behind a single channel on the
     pipelined wall-clock AND survive the per-rank replay fidelity
     gate; plus cross-step pipelining — the 2-step scoring DAG beats 2x
     the single-step wall-clock by overlapping across the step boundary.
  9. Long-context sliding-window attention: the SAME model
     priced windowed (32k prompt, 4k ring-buffer window) vs as its
     full-attention twin — the windowed decode plan (ring-sized KV
     protos/migration) and the BANDED prefill DAG (dead cross-chunk KV
     edges dropped) must each STRICTLY beat the full-attention plan,
     with replay error through the fidelity gate.

Every sweep row also reports the planner-fidelity round trip
(`replay err %`): the plan's predicted `pipelined_s` against the
re-priced replay of its own modeled execution trace
(`repro_torch.dispatch.trace`, DESIGN.md §13).

Finally the reduced-scale pipelines are actually executed through
`dispatch.runtime` on `device` (the card unless the caller asks for the
CPU) — and dispatch-backed `ServeEngine` runs (dense decode at the
default dtype, MoE decode on the f32 mixtral-reduced model) are checked
token-identical against the fused engine. A closing section records a
MEASURED trace of the dispatch serving decode step (host clock), reports
the tracing overhead against the <5% budget, gates the planner's
prediction against the replayed trace, and (with `--trace OUT_JSON`)
exports the trace plus its Chrome trace_event twin.

`run(report, quick=True)` (`python -m repro_torch.benchmarks.run
dispatch_bench --quick`) runs only a reduced
prefill-DAG sweep plus a reduced MoE sweep: DAG build, both planner
objectives, the overlapped<=serial gate, the pure-baseline comparison,
the serial-chunk-loop vs pipelined-executor timeline comparison, the
MoE exchange bookkeeping asserts, and the reduced-dims sliding-window
sweep (the sweep-9 inequalities at window 8).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import torch

from .. import prim
from ..device import resolve_device
from ..dispatch import trace as dtrace
from ..dispatch import workloads
from ..dispatch.placement import (compare_plans, node_time, plan,
                                  pure_plan)
from ..dispatch.schedule import make_schedule

SEED = 0


def _pipelined_no_later(sched) -> bool:
    """One schedule's pipelined wall-clock is no later than its serial
    groups' (`pipelined_s <= overlapped_s`), up to the rounding of the two
    sums over the same groups in different orders: the reference's 1e-15 s
    slack, or one float64 epsilon of the total per group where that is
    more (1e-15 s is below one ulp of a paper-scale total of seconds)."""
    eps = sys.float_info.epsilon * len(sched.groups) * sched.overlapped_s
    return sched.pipelined_s <= sched.overlapped_s + max(1e-15, eps)


def _replay_err(graph, p):
    """Predicted-vs-replayed relative error (%) for one plan row: the
    plan's predicted `pipelined_s` against the re-priced replay of its
    own modeled trace (the record->replay round trip, DESIGN.md §13)."""
    return round(dtrace.fidelity(graph, p).rel_err * 100.0, 2)


def _prefill_sweep(report, dims, prefill_len, chunk, bnb_budget=20_000):
    """Plan one chunked prefill DAG under both objectives; assert the
    acceptance inequalities and report the residency trade."""
    dag = workloads.prefill_dag(dims, prefill_len=prefill_len, chunk=chunk)
    serial = plan(dag, bnb_budget=bnb_budget)
    over = plan(dag, bnb_budget=bnb_budget, objective="overlapped")
    serial_sched = make_schedule(dag, serial)
    pim = pure_plan(dag, "upmem_2556")
    cpu_kv_pim = pure_plan(dag, "xeon")
    rehomed_dag = workloads.prefill_dag(dims, prefill_len=prefill_len,
                                        chunk=chunk, kv_home="xeon")
    cpu_rehomed = pure_plan(rehomed_dag, "xeon")
    report.table([
        {"plan": "pure_pim (KV@pim)",
         "serial ms": round(pim.total_s * 1e3, 1),
         "overlapped ms": round(make_schedule(dag, pim).overlapped_s
                                * 1e3, 1),
         "replay err %": _replay_err(dag, pim)},
        {"plan": "pure_cpu (KV@pim: migrate+writeback)",
         "serial ms": round(cpu_kv_pim.total_s * 1e3, 1),
         "overlapped ms": round(make_schedule(dag, cpu_kv_pim).overlapped_s
                                * 1e3, 1),
         "replay err %": _replay_err(dag, cpu_kv_pim)},
        {"plan": "pure_cpu (KV re-homed to host)",
         "serial ms": round(cpu_rehomed.total_s * 1e3, 1),
         "overlapped ms": "-",
         "replay err %": _replay_err(rehomed_dag, cpu_rehomed)},
        {"plan": f"planned, objective=serial [{serial.method}]",
         "serial ms": round(serial.total_s * 1e3, 1),
         "overlapped ms": round(serial_sched.overlapped_s * 1e3, 1),
         "replay err %": _replay_err(dag, serial)},
        {"plan": f"planned, objective=overlapped [{over.method}]",
         "serial ms": round(over.total_s * 1e3, 1),
         "overlapped ms": round(over.overlapped_s * 1e3, 1),
         "replay err %": _replay_err(dag, over)},
    ])
    # acceptance: the planner never loses to a pure placement of
    # the same graph, and the overlapped objective never schedules worse
    # than the serial plan
    assert serial.total_s <= pim.total_s and \
        serial.total_s <= cpu_kv_pim.total_s, "planned prefill >= a pure"
    assert over.overlapped_s <= serial_sched.overlapped_s + 1e-15, \
        "overlapped objective scheduled worse than the serial plan"
    writeback = sum(g.writeback_s for g in serial_sched.groups)
    report.note(
        f"{len(dag.nodes)}-node DAG (frontier {dag.max_frontier()}, "
        f"method {serial.method}): prefill "
        "is compute-dense (KT1) so the planner keeps it host-side and "
        f"pays {serial.migrate_s * 1e3:.1f}ms of KV traffic "
        f"({writeback * 1e3:.1f}ms write-back in the timeline) to keep "
        "the cache bank-resident for decode; re-homing the cache to the "
        f"host would save {(serial.total_s - cpu_rehomed.total_s) * 1e3:.1f}"
        "ms of prefill but forfeit decode's at-home attention (sweep 4)")

    # serial chunk loop vs pipelined executor timeline: the same
    # overlapped-objective plan, priced under the pre-executor discipline
    # (chunk-major linearization, launch groups strictly serialized) and
    # under the executor's pipelined discipline (interleaved timeline,
    # write-backs hidden under later chunks' compute)
    loop_order = workloads.prefill_serial_order(dag)
    loop_s = make_schedule(dag, over, order=loop_order).overlapped_s
    pipe_s = make_schedule(dag, over, pipelined=True).pipelined_s
    report.table([
        {"prefill execution": "serial chunk loop (pre-executor)",
         "wall-clock ms": round(loop_s * 1e3, 2),
         "tokens/s": round(prefill_len / loop_s)},
        {"prefill execution": "pipelined executor timeline",
         "wall-clock ms": round(pipe_s * 1e3, 2),
         "tokens/s": round(prefill_len / pipe_s)},
    ])
    assert pipe_s <= loop_s + 1e-15, \
        "pipelined executor slower than the serial chunk loop"
    report.note(f"pipelined cross-chunk prefill is "
                f"{(loop_s / pipe_s - 1) * 100:.1f}% faster than the "
                "serial chunk loop (chunk i+1's qkv ladder runs under "
                "chunk i's KV write-back; launch groups overlap across "
                "devices)")
    return dag, serial, over, loop_s, pipe_s


def _moe_sweep(report, dims):
    """Plan one MoE decode DAG (router -> token exchange -> expert FFNs
    -> combine exchange per layer); assert the acceptance
    inequalities and report what the exchange edges cost each plan."""
    dag = workloads.moe_decode_dag(dims)
    hybrid = plan(dag)
    rehomed_dag = workloads.moe_decode_dag(dims, kv_home="xeon")
    cpu = pure_plan(rehomed_dag, "xeon")
    pim = pure_plan(dag, "upmem_2556")
    sched = make_schedule(dag, hybrid, pipelined=True)
    report.table([
        {"plan": "pure_cpu (KV re-homed to host)",
         "modeled ms": round(cpu.total_s * 1e3, 3),
         "exchange ms": round(cpu.exchange_s * 1e3, 3),
         "replay err %": _replay_err(rehomed_dag, cpu)},
        {"plan": "pure_pim (KV@pim)",
         "modeled ms": round(pim.total_s * 1e3, 3),
         "exchange ms": round(pim.exchange_s * 1e3, 3),
         "replay err %": _replay_err(dag, pim)},
        {"plan": f"hybrid [{hybrid.method}]",
         "modeled ms": round(hybrid.total_s * 1e3, 3),
         "exchange ms": round(hybrid.exchange_s * 1e3, 3),
         "replay err %": _replay_err(dag, hybrid)},
    ])
    # acceptance: the hybrid strictly beats both steelmanned
    # pures, and only the all-PIM plan pays the host-relayed exchanges
    assert hybrid.total_s < cpu.total_s, "MoE hybrid >= pure CPU"
    assert hybrid.total_s < pim.total_s, "MoE hybrid >= pure PIM"
    assert pim.exchange_s > 0, "pure PIM paid no exchange"
    n_exchanges = sum(g.n_exchanges for g in sched.groups)
    assert _pipelined_no_later(sched)
    report.note(
        f"{len(dag.nodes)}-node MoE DAG (frontier {dag.max_frontier()}, "
        f"method {hybrid.method}): attention stays at the bank-resident "
        "KV; router/experts plan onto the host, so the hybrid pays "
        f"{hybrid.exchange_s * 1e3:.3f}ms of exchange vs pure PIM's "
        f"{pim.exchange_s * 1e3:.3f}ms (2 host-relayed all-to-alls per "
        f"layer; {n_exchanges} booked in the hybrid timeline) — "
        "all-to-all volume scales with tokens x capacity, not experts")
    return dag, hybrid, cpu, pim


def _moe_quant_gate(report, f32_hybrid):
    """KT2-flip headline gate: plan the int8-quantized MoE
    decode DAG (int8 expert weights with int32 accumulation, int8 KV) at
    the same mixtral-8x7b dims and assert the flip — the dtype-aware
    planner now puts EVERY expert FFN on the DPU grid (the 8x8-multiplier
    band prices int8 muls at 2 cycles vs float's 32-cycle software
    ladder) and the quantized hybrid strictly beats the f32 hybrid's
    host-heavy MoE plan."""
    dag = workloads.moe_decode_dag(workloads.MOE_PAPER_DIMS_INT8)
    hybrid = plan(dag)
    over = plan(dag, objective="overlapped")
    experts = [n for n, node in dag.nodes.items()
               if node.kind == "moe_expert"]
    on_pim = sum(1 for n in experts
                 if hybrid.assignment[n].startswith("upmem"))
    report.table([
        {"plan": "f32 hybrid (sweep above)",
         "modeled ms": round(f32_hybrid.total_s * 1e3, 3),
         "experts on PIM": sum(
             1 for n in experts
             if f32_hybrid.assignment[n].startswith("upmem"))},
        {"plan": f"int8 hybrid [{hybrid.method}]",
         "modeled ms": round(hybrid.total_s * 1e3, 3),
         "experts on PIM": on_pim,
         "replay err %": _replay_err(dag, hybrid)},
    ])
    # acceptance: the quantized experts land bank-parallel under
    # BOTH objectives and the quantized hybrid strictly wins end to end
    assert experts and on_pim == len(experts), \
        f"only {on_pim}/{len(experts)} quantized experts on PIM"
    assert all(over.assignment[n].startswith("upmem") for n in experts), \
        "overlapped objective hosted a quantized expert"
    assert hybrid.total_s < f32_hybrid.total_s, \
        "quantized MoE hybrid did not beat the f32 hybrid (KT2 not flipped)"
    report.note(
        f"KT2 flipped: all {len(experts)} expert FFNs plan onto the DPU "
        "grid once their GEMMs hit the native 8x8-multiplier band "
        f"(int8 mul = 2 cycles); the quantized hybrid models "
        f"{f32_hybrid.total_s / hybrid.total_s:.2f}x faster than the f32 "
        "hybrid whose float experts were host-bound")
    return hybrid


def _multi_rank_sweep(report, quant_hybrid):
    """Sweep 8: multi-rank scale-out. Shard the quantized
    mixtral MoE decode DAG's expert FFNs over 4 PIM ranks
    (`expert_parallel_plan`) and price the SAME sharded graph under a
    1-rank topology (every shard behind the one host channel) vs the
    4-rank topology (one transfer channel per rank) — isolating what
    rank-parallel CPU<->DPU transfers and per-rank exchange relays buy
    with compute held fixed. The second half prices cross-step
    pipelining: the 2-step scoring DAG (no sampled-token dependence, so
    step i+1's embed overlaps under step i's head) against 2x the
    single-step wall-clock."""
    from ..dispatch.placement import Topology
    dims = workloads.MOE_PAPER_DIMS_INT8
    g = workloads.moe_decode_dag(dims, expert_shards=4)
    p1 = workloads.expert_parallel_plan(g, Topology(n_ranks=1))
    p4 = workloads.expert_parallel_plan(g, Topology(n_ranks=4))
    s1 = make_schedule(g, p1, pipelined=True)
    s4 = make_schedule(g, p4, pipelined=True)
    report.table([
        {"plan": "expert-parallel x4, 1 rank (single channel)",
         "pipelined ms": round(s1.pipelined_s * 1e3, 3),
         "overlapped ms": round(s1.overlapped_s * 1e3, 3),
         "replay err %": _replay_err(g, p1)},
        {"plan": "expert-parallel x4, 4 ranks (per-rank channels)",
         "pipelined ms": round(s4.pipelined_s * 1e3, 3),
         "overlapped ms": round(s4.overlapped_s * 1e3, 3),
         "replay err %": _replay_err(g, p4)},
        {"plan": "unsharded int8 hybrid (sweep 7)",
         "pipelined ms": round(
             make_schedule(workloads.moe_decode_dag(dims), quant_hybrid,
                           pipelined=True).pipelined_s * 1e3, 3),
         "overlapped ms": "-", "replay err %": "-"},
    ])
    # acceptance: the 4-rank plan strictly beats the single
    # channel on the modeled pipelined wall-clock, and its prediction
    # survives the per-rank replay round trip inside the fidelity band
    assert s4.pipelined_s < s1.pipelined_s, \
        "4-rank expert-parallel plan did not beat the single channel"
    fid = dtrace.fidelity(g, p4)
    assert fid.ok, f"multi-rank fidelity {fid.rel_err:.1%} out of band"
    report.note(
        f"4 ranks model {s1.pipelined_s / s4.pipelined_s:.2f}x faster "
        "than the same sharded plan behind one channel: each rank's "
        "expert slice stages in/exchanges over its own host channel, so "
        "the router scatter and combine gather parallelize across ranks "
        f"(per-rank replay err {fid.rel_err * 100:.2f}%)")

    # cross-step pipelining: scoring/speculative-verification steps chain
    # attn{i}/s{k} -> attn{i}/s{k+1} (KV order) but NOT head -> embed
    g2 = workloads.decode_steps_dag(dims, n_steps=2)
    p_2 = plan(g2, objective="overlapped")
    s_2 = make_schedule(g2, p_2, pipelined=True)
    one = make_schedule(workloads.moe_decode_dag(dims),
                        plan(workloads.moe_decode_dag(dims),
                             objective="overlapped"),
                        pipelined=True).pipelined_s
    report.table([
        {"steps": "1 (x2, serialized)",
         "pipelined ms": round(2 * one * 1e3, 3), "replay err %": "-"},
        {"steps": "2 (cross-step DAG, scoring)",
         "pipelined ms": round(s_2.pipelined_s * 1e3, 3),
         "replay err %": _replay_err(g2, p_2)},
    ])
    assert s_2.pipelined_s < 2 * one, \
        "cross-step DAG failed to overlap across the step boundary"
    report.note(
        f"2 pipelined steps model {(2 * one - s_2.pipelined_s) * 1e3:.1f} "
        "ms under 2x one step: step 2's embed/QKV start while step 1's "
        "head is still in flight (sampled decode would re-serialize via "
        "head -> embed; `decode_steps_dag(sampled=True)` prices that)")


def _swa_sweep(report, dims, prefill_len, chunk, bnb_budget=20_000):
    """Sweep 9: long-context sliding-window attention. Price
    the SAME model twice — once with a ring-buffer KV window
    (`DecodeDims.window`, attention protos/migration sized at
    min(kv_len, window) rows) and once as its full-attention twin
    (window=0) — for both phases: the windowed decode DAG vs the
    full-cache decode DAG, and the BANDED prefill DAG (cross-chunk KV
    edges outside the window dropped, `prefill_live_from`) vs the full
    lower-triangular prefill DAG at the same prompt/chunking. The
    windowed hybrid must STRICTLY beat the full-attention plan in both
    phases, and its predictions must survive the replay fidelity gate."""
    full = dataclasses.replace(dims, window=0)

    # decode: ring-sized KV vs the full cache
    dag_w = workloads.decode_dag(dims)
    dag_f = workloads.decode_dag(full)
    p_w, p_f = plan(dag_w), plan(dag_f)
    report.table([
        {"decode plan": f"full attention ({full.kv_len}-row KV)",
         "modeled ms": round(p_f.total_s * 1e3, 3),
         "kv-migrate ms": round(p_f.migrate_s * 1e3, 3),
         "replay err %": _replay_err(dag_f, p_f)},
        {"decode plan": f"windowed ({dims.kv_len}-slot ring) "
                        f"[{p_w.method}]",
         "modeled ms": round(p_w.total_s * 1e3, 3),
         "kv-migrate ms": round(p_w.migrate_s * 1e3, 3),
         "replay err %": _replay_err(dag_w, p_w)},
    ])
    # acceptance (decode): at the same model dims the windowed
    # plan strictly beats full attention — the ring cache is the only
    # difference, so every win is attention rows not priced
    assert p_w.total_s < p_f.total_s, \
        "windowed decode hybrid did not beat the full-attention plan"
    fid_d = dtrace.fidelity(dag_w, p_w)
    assert fid_d.ok, \
        f"windowed decode fidelity {fid_d.rel_err:.1%} out of band"

    # prefill: banded DAG (dead cross-chunk KV edges dropped) vs full
    pre_w = workloads.prefill_dag(dims, prefill_len=prefill_len,
                                  chunk=chunk)
    pre_f = workloads.prefill_dag(full, prefill_len=prefill_len,
                                  chunk=chunk)
    q_w = plan(pre_w, bnb_budget=bnb_budget)
    q_f = plan(pre_f, bnb_budget=bnb_budget)
    s_w = make_schedule(pre_w, q_w, pipelined=True)
    s_f = make_schedule(pre_f, q_f, pipelined=True)
    edges_w = sum(len(p) for p in pre_w.preds.values())
    edges_f = sum(len(p) for p in pre_f.preds.values())
    report.table([
        {"prefill plan": f"full causal ({edges_f} edges)",
         "serial ms": round(q_f.total_s * 1e3, 1),
         "pipelined ms": round(s_f.pipelined_s * 1e3, 1),
         "replay err %": _replay_err(pre_f, q_f)},
        {"prefill plan": f"banded, window {dims.window} "
                         f"({edges_w} edges) [{q_w.method}]",
         "serial ms": round(q_w.total_s * 1e3, 1),
         "pipelined ms": round(s_w.pipelined_s * 1e3, 1),
         "replay err %": _replay_err(pre_w, q_w)},
    ])
    # acceptance (prefill): the banded DAG strictly beats the
    # full plan — dropped KV edges are flops, residency, AND write-back
    # the planner never has to schedule
    assert edges_w < edges_f, "banded prefill DAG dropped no edges"
    assert q_w.total_s < q_f.total_s, \
        "banded prefill plan did not beat the full-attention plan"
    assert s_w.pipelined_s <= s_f.pipelined_s + 1e-15, \
        "banded prefill pipelines worse than full attention"
    fid_p = dtrace.fidelity(pre_w, q_w)
    assert fid_p.ok, \
        f"banded prefill fidelity {fid_p.rel_err:.1%} out of band"
    report.note(
        f"window {dims.window} of {full.seq}: windowed decode models "
        f"{p_f.total_s / p_w.total_s:.2f}x faster than full attention "
        f"(ring holds {dims.kv_len} of {full.kv_len} KV rows); banded "
        f"prefill drops {edges_f - edges_w} dead cross-chunk edges and "
        f"models {q_f.total_s / q_w.total_s:.2f}x faster serial, "
        f"{s_f.pipelined_s / s_w.pipelined_s:.2f}x pipelined (decode "
        f"replay err {fid_d.rel_err * 100:.2f}%, prefill "
        f"{fid_p.rel_err * 100:.2f}%)")


def _three_way(report, graph, devices=("xeon", "upmem_2556")):
    plans = compare_plans(graph, devices=devices)
    rows = [{"plan": k, "modeled ms": round(p.total_s * 1e3, 3),
             "compute ms": round(p.compute_s * 1e3, 3),
             "transfer ms": round(p.transfer_s * 1e3, 3),
             "launches": round(p.launch_s * 1e3, 3),
             "devices": "+".join(p.used_devices),
             "replay err %": _replay_err(graph, p)}
            for k, p in plans.items()]
    report.table(rows)
    sched = make_schedule(graph, plans["hybrid"])
    report.raw(sched.render())
    return plans, sched


def _trace_section(report, device, trace_out=None, steps: int = 20):
    """Record a measured execution trace of the dispatch-backed serving
    decode step, measure the tracing overhead (traced vs untraced host
    wall-clock over the same step loop — the <5% budget), gate the
    planner's prediction against the replayed trace, and optionally
    export the trace (JSON + Chrome trace_event twin)."""
    from ..configs import REDUCED
    from ..models import init_params
    from ..serve import Request, ServeEngine

    cfg = REDUCED["granite-3-8b"]
    params = init_params(SEED, cfg, device)
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=512,
                      device=device, engine="dispatch",
                      dispatch_kwargs={"prefill_engine": "jit"})
    for i in range(2):   # fill both slots; budget outlasts every loop below
        eng.admit(Request(i, torch.arange(4, dtype=torch.int32) + 3, 10_000))

    def step_loop(n):
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        return time.perf_counter() - t0

    step_loop(5)                         # warm-up: build every face once
    untraced = min(step_loop(steps) for _ in range(3))
    tracer = dtrace.Trace(name=f"bench:{cfg.name}:dispatch")
    tracer.meta.update(arch=cfg.name, engine="dispatch",
                       assignment=dict(eng._dispatch_decode.executor
                                       .assignment))
    eng.attach_tracer(tracer)
    traced = min(step_loop(steps) for _ in range(3))
    eng.attach_tracer(None)
    overhead = traced / untraced - 1.0
    report.table([
        {"decode loop": "untraced",
         f"best-of-3 wall s ({steps} steps)": round(untraced, 4),
         "ms/step": round(untraced / steps * 1e3, 3)},
        {"decode loop": "traced",
         f"best-of-3 wall s ({steps} steps)": round(traced, 4),
         "ms/step": round(traced / steps * 1e3, 3)},
    ])
    report.note(f"tracing overhead: {overhead * 100.0:+.2f}% of untraced "
                "executor wall-clock (budget <5%: a trace event is two "
                "perf_counter reads and a dict append per span)")
    rep = dtrace.fidelity(eng._dispatch_decode.dag, eng._dispatch_decode.plan,
                          trace=tracer)
    report.raw("  " + rep.render())
    assert rep.ok, "measured serving trace replays outside the gate band"
    if trace_out:
        chrome = (trace_out[:-5] if trace_out.endswith(".json")
                  else trace_out) + ".chrome.json"
        tracer.save(trace_out)
        tracer.save_chrome(chrome)
        n_steps = len(tracer.by_kind("decode_step"))
        report.note(f"trace: {len(tracer.events)} events ({n_steps} decode "
                    f"steps) -> {trace_out} (+ {chrome})")
    return overhead


def _prompts(vocab: int, n: int, seed: int) -> list:
    """`n` prompts of 3-8 random tokens, drawn on the CPU from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    lens = torch.randint(3, 9, (n,), generator=gen).tolist()
    return [torch.randint(0, vocab, (k,), generator=gen, dtype=torch.int32)
            for k in lens]


def _serve_both(cfg, params, prompts, device) -> dict:
    """Serve `prompts` (4 new tokens each) through the fused engine and
    through the dispatch engine (fused prefill): engine -> {rid: tokens}."""
    from ..serve import Request, ServeEngine
    outs = {}
    for engine in ("jit", "dispatch"):
        # fused prefill here: the sweep gates decode identity (the
        # dispatch prefill's gates are tests/test_torch_dispatch_*.py's)
        kw = ({"dispatch_kwargs": {"prefill_engine": "jit"}}
              if engine == "dispatch" else {})
        eng = ServeEngine(cfg, params, batch_slots=2, max_len=48,
                          device=device, engine=engine, **kw)
        done = eng.serve([Request(i, p, 4) for i, p in enumerate(prompts)])
        outs[engine] = {r.rid: r.out_tokens for r in done}
    return outs


def run(report, quick: bool = False, trace_out: str | None = None,
        device=None):
    """Drive the sweeps; `quick` keeps the reduced smoke sweeps (and, with
    `trace_out`, the measured trace section). The executed pipelines,
    serving checks and traces run on `device` (None: the card)."""
    device = resolve_device(device)
    if quick:
        # CI smoke: the chunked prefill DAG at reduced scale, both
        # objectives, acceptance gates asserted
        report.section("QUICK: chunked prefill DAG (reduced dims, "
                       "2 chunks), serial vs overlapped objective")
        _prefill_sweep(report, workloads.REDUCED_DIMS, prefill_len=8,
                       chunk=4)
        # MoE smoke: the routed-expert decode DAG at reduced
        # dims — exchange bookkeeping + pure-baseline asserts only (the
        # strict hybrid win is a paper-scale property, sweep 6)
        report.section("QUICK: MoE decode DAG (reduced dims, 4 experts "
                       "top-2), exchange-phase bookkeeping")
        dag = workloads.moe_decode_dag(workloads.MOE_REDUCED_DIMS)
        hybrid = plan(dag)
        pim = pure_plan(dag, "upmem_2556")
        sched = make_schedule(dag, pim, pipelined=True)
        report.table([
            {"plan": "pure_pim", "modeled ms": round(pim.total_s * 1e3, 3),
             "exchange ms": round(pim.exchange_s * 1e3, 3),
             "replay err %": _replay_err(dag, pim)},
            {"plan": f"planned [{hybrid.method}]",
             "modeled ms": round(hybrid.total_s * 1e3, 3),
             "exchange ms": round(hybrid.exchange_s * 1e3, 3),
             "replay err %": _replay_err(dag, hybrid)},
        ])
        assert hybrid.total_s <= pim.total_s, "MoE planned >= pure PIM"
        assert hybrid.total_s <= pure_plan(dag, "xeon").total_s
        assert pim.exchange_s > 0, "pure PIM paid no MoE exchange"
        assert sum(g.n_exchanges for g in sched.groups) == \
            2 * workloads.MOE_REDUCED_DIMS.n_layers
        assert _pipelined_no_later(sched)
        report.note("MoE routing planned as an exchange phase: all-PIM "
                    "pays 2 host-relayed all-to-alls per layer "
                    "(transfer-channel-only occupancy in the timeline)")
        # quantized smoke: the int8 MoE DAG builds with the
        # int8 mul band on its expert nodes and the DPU prices a
        # quantized expert strictly below its f32 twin (the paper-scale
        # PIM flip itself is sweep 7's gate — at reduced dims everything
        # is host-cheap and the flip is not expected)
        report.section("QUICK: quantized MoE decode DAG (int8 experts + "
                       "int8 KV, reduced dims)")
        dag8 = workloads.moe_decode_dag(workloads.MOE_REDUCED_DIMS_INT8)
        h8 = plan(dag8)
        assert dag8.name.endswith("-int8"), dag8.name
        experts = [n for n, node in dag8.nodes.items()
                   if node.kind == "moe_expert"]
        assert experts and all(
            dag8.nodes[n].ops.get(("mul", "int8"), 0) > 0 for n in experts
        ), "quantized expert nodes lost the int8 mul band"
        pim8_ms = node_time(dag8.nodes["expert0"], "upmem_2556") * 1e3
        pim32_ms = node_time(dag.nodes["expert0"], "upmem_2556") * 1e3
        assert pim8_ms < pim32_ms, \
            "DPU does not price the int8 expert below the f32 expert"
        report.table([
            {"plan": f"int8 hybrid [{h8.method}]",
             "modeled ms": round(h8.total_s * 1e3, 3),
             "expert0 on-DPU ms (int8)": round(pim8_ms, 3),
             "expert0 on-DPU ms (f32)": round(pim32_ms, 3),
             "replay err %": _replay_err(dag8, h8)},
        ])
        report.note("int8 expert GEMMs carry the ('mul','int8') band end "
                    "to end — the dtype class the planner reprices at the "
                    "DPU's native 8x8 multiplier (2 cycles vs float's "
                    "32-cycle software ladder; sweep 7 gates the "
                    "paper-scale flip)")
        # sliding-window smoke: windowed vs full at reduced
        # dims — the same strict inequalities as sweep 9, small graphs
        report.section("QUICK: sliding-window attention (reduced dims, "
                       "window 8), windowed vs full-attention plans")
        _swa_sweep(report, workloads.SWA_REDUCED_DIMS,
                   **workloads.PREFILL_SWA_REDUCED)
        if trace_out:
            report.section("QUICK: execution tracing (measured dispatch "
                           "serving trace, overhead, fidelity)")
            _trace_section(report, device, trace_out, steps=10)
        return

    # -- sweep 1: the 16 PrIM workloads, one operator each ----------------
    report.section("PrIM workloads: planner device pick vs Fig.-4 grouping")
    rows, recovered = [], 0
    for counts in prim.all_ref_counts():
        g = workloads.prim_graph(counts)
        cpu = pure_plan(g, "xeon").total_s
        pim = pure_plan(g, "upmem_2556").total_s
        hyb = plan(g, devices=("xeon", "titan_v", "upmem_2556"))
        pick = hyb.assignment[counts.name]
        if not counts.pim_suitable and hyb.total_s < pim:
            recovered += 1
        rows.append({"workload": counts.name,
                     "suitable": "Y" if counts.pim_suitable else "n",
                     "cpu ms": round(cpu * 1e3, 2),
                     "pim ms": round(pim * 1e3, 2),
                     "planned ms": round(hyb.total_s * 1e3, 2),
                     "pick": pick,
                     "replay err %": _replay_err(g, hyb)})
    report.table(rows)
    report.note(f"planner recovers {recovered} of the "
                f"{sum(1 for c in prim.all_ref_counts() if not c.pim_suitable)}"
                " group-2 workloads pure PIM loses (picks a better device)")

    # -- sweep 2: mixed PrIM pipeline ------------------------------------
    report.section("Mixed PrIM pipeline (stream -> reorganize -> stream), "
                   "4096x4096 int32")
    g = workloads.mixed_pipeline(m=4096, concrete=False).graph()
    plans, _ = _three_way(report, g)
    assert plans["hybrid"].total_s < plans["pure_cpu"].total_s, "hybrid>=cpu"
    assert plans["hybrid"].total_s < plans["pure_pim"].total_s, "hybrid>=pim"
    report.note("hybrid strictly beats both pure plans: streams run "
                "bank-parallel, the transpose/rotate middle goes to the host")

    # -- sweep 3: LM decode step at paper scale --------------------------
    report.section("LM decode step (weight GEMVs + quantized KV attention), "
                   "4k d_model / 32 layers / 2k cache")
    dg = workloads.decode_pipeline(workloads.DecodeDims(),
                                   concrete=False).graph()
    plans, _ = _three_way(report, dg)
    assert plans["hybrid"].total_s < plans["pure_cpu"].total_s, "hybrid>=cpu"
    assert plans["hybrid"].total_s < plans["pure_pim"].total_s, "hybrid>=pim"
    n_pim = sum(1 for d in plans["hybrid"].assignment.values()
                if d.startswith("upmem"))
    report.note(f"{n_pim} of {len(dg.nodes)} decode operators placed "
                "bank-parallel (the KV-cache attention); float-mul GEMVs "
                "stay on the host (KT2)")

    # -- sweep 4: decode DAG + KV residency (the serving planner) --------
    report.section("Decode DAG (residuals kept, KV bank-resident), "
                   "exact frontier-DP plan vs steelmanned pures")
    dims = workloads.DecodeDims()
    dag = workloads.decode_dag(dims)                  # KV homed on PIM
    hybrid = plan(dag)
    cpu = pure_plan(workloads.decode_dag(dims, kv_home="xeon"), "xeon")
    pim = pure_plan(dag, "upmem_2556")
    report.table([
        {"plan": "pure_cpu (KV@host)", "modeled ms":
            round(cpu.total_s * 1e3, 3),
         "kv-migrate ms": round(cpu.migrate_s * 1e3, 3)},
        {"plan": "pure_pim (KV@pim)", "modeled ms":
            round(pim.total_s * 1e3, 3),
         "kv-migrate ms": round(pim.migrate_s * 1e3, 3)},
        {"plan": f"hybrid [{hybrid.method}]", "modeled ms":
            round(hybrid.total_s * 1e3, 3),
         "kv-migrate ms": round(hybrid.migrate_s * 1e3, 3)},
    ])
    # acceptance: dispatch-planned decode beats both pures at
    # paper scale, each pure given its best-case KV residency
    assert hybrid.total_s < cpu.total_s, "hybrid>=cpu on decode DAG"
    assert hybrid.total_s < pim.total_s, "hybrid>=pim on decode DAG"
    assert hybrid.method == "dag-dp", "decode DAG fell off the exact rung"
    report.note(f"{len(dag.nodes)}-node DAG (frontier width "
                f"{dag.max_frontier()}) planned exactly by the frontier "
                "DP; attention pinned to the KV home, residual/GEMV "
                "stream on the host")

    # -- sweep 5: chunked prefill DAG, serial vs overlapped objective ----
    report.section("Chunked prefill DAG (2048 tokens / 4x512 chunks, KV "
                   "bank-resident), serial vs overlapped objective")
    _, _, _, loop_s, pipe_s = _prefill_sweep(report, dims,
                                             prefill_len=2048, chunk=512)
    # acceptance: at the paper-scale config the pipelined executor
    # timeline STRICTLY beats the serial chunk loop's throughput
    assert pipe_s < loop_s, \
        "pipelined prefill does not beat the serial chunk loop at paper scale"

    # -- sweep 6: MoE decode DAG, routing as an exchange phase -----------
    report.section("MoE decode DAG (mixtral-8x7b dims: 8 experts top-2, "
                   "token/combine exchanges), hybrid vs steelmanned pures")
    _, f32_hybrid, _, _ = _moe_sweep(report, workloads.MOE_PAPER_DIMS)

    # -- sweep 7: the KT2 flip — int8 experts/KV vs the f32 hybrid -------
    report.section("Quantized MoE decode DAG (int8 experts + int8 KV), "
                   "the KT2 flip vs the f32 hybrid")
    quant_hybrid = _moe_quant_gate(report, f32_hybrid)

    # -- sweep 8: multi-rank scale-out + cross-step pipelining -----------
    report.section("Multi-rank scale-out (4-rank expert parallelism, "
                   "per-rank channels) + cross-step pipelining")
    _multi_rank_sweep(report, quant_hybrid)

    # -- sweep 9: long-context sliding-window attention ------------------
    report.section("Long-context sliding-window attention (32k prompt, "
                   "4k window): windowed vs full-attention plans")
    _swa_sweep(report, workloads.SWA_PAPER_DIMS, **workloads.PREFILL_SWA)

    # -- execute the plans for real (reduced scale) ----------------------
    report.section("Runtime validation (reduced scale, real execution)")
    from ..core.bank_parallel import BankGrid
    from ..dispatch.runtime import check_phase_discipline, execute
    grid = BankGrid(1, device)
    rows = []
    for pipe in (workloads.mixed_pipeline(m=256, seed=SEED, device=device),
                 workloads.decode_pipeline(seed=SEED, device=device)):
        pg = pipe.graph()
        p = plan(pg)
        rep = execute(pipe, p, grid)
        rows.append({"pipeline": pipe.name, "stages": len(pipe.stages),
                     "allclose vs reference": rep.matches,
                     "max |err|": f"{rep.max_abs_err:.2e}",
                     "local phases checked":
                         check_phase_discipline(pipe, grid)})
    report.table(rows)

    # -- dispatch-backed serving: planner-routed == fused ----------------
    report.section("Dispatch-backed ServeEngine (reduced scale)")
    from ..configs import REDUCED
    from ..models import init_params
    cfg = REDUCED["granite-3-8b"]
    params = init_params(SEED, cfg, device)
    outs = _serve_both(cfg, params, _prompts(cfg.vocab_size, 6, 7), device)
    assert outs["jit"] == outs["dispatch"], \
        "dispatch-backed decode diverged from the fused engine"
    report.table([{"engine": e, "requests": len(outs[e]),
                   "tokens": sum(len(t) for t in outs[e].values())}
                  for e in outs])
    report.note("dispatch-backed decode is token-identical to the "
                "fused engine over a continuous-batching run")

    # -- dispatch-backed MoE serving (f32 mixtral-reduced) ---------------
    report.section("Dispatch-backed MoE ServeEngine (mixtral-reduced, f32)")
    moe_cfg = dataclasses.replace(REDUCED["mixtral-8x7b"], dtype="float32")
    moe_params = init_params(SEED, moe_cfg, device)
    # fused prefill: chunked MoE prefill has per-chunk capacity semantics
    # (serve.dispatch_engine docstring); the decode path is the
    # planner-routed ladder under test
    moe_outs = _serve_both(moe_cfg, moe_params,
                           _prompts(moe_cfg.vocab_size, 5, 17), device)
    assert moe_outs["jit"] == moe_outs["dispatch"], \
        "dispatch-backed MoE decode diverged from the fused engine"
    report.table([{"engine": e, "requests": len(moe_outs[e]),
                   "tokens": sum(len(t) for t in moe_outs[e].values())}
                  for e in moe_outs])
    report.note("dispatch-backed MoE decode (router -> exchange -> "
                "experts -> combine) is token-identical to the fused "
                "engine at f32")

    # -- execution tracing: overhead + planner fidelity ------------------
    report.section("Execution tracing: overhead budget and planner "
                   "fidelity on a measured serving trace")
    _trace_section(report, device, trace_out)
