"""The port's planner core (`repro_torch.dispatch.{graph, placement,
schedule, plan_cache}`) against the reference planner on the same graphs.

The reference builds every shipped graph (`repro.dispatch.workloads.
shipped_graphs()`: its stages compiled by XLA and counted from HLO); each
graph travels as JSON into the port's `OpGraph`, and both planners plan
it. For every case of `tests/test_golden_plans.py::_cases` (both
objectives) the port's plan and `make_schedule(pipelined=True)` are held
to the reference's on that graph: placement, method, objective, stage
boundaries and launch groups exactly, `overlapped_s` and `pipelined_s`
within rel 1e-9. The cases are split over this file and
tests/test_torch_planner_{moe,swa,swa32k}.py, so that each file builds
and plans only its graphs in well under a minute.
They are not held to the goldens' wall-clocks, which drift with the XLA
census (ROADMAP F4).

The port's own 16 `prim/*` graphs, built from `core.perf_model`, are held
to `tests/golden_plans.json`. The port's `dp-overlap` reports the cost of
the schedule it plans: on the random ranked chains of
`tests/test_planner_properties.py` (seed 327063163 pinned, the reference's
F1 case) it equals brute force and `make_schedule`.
"""

import functools
import itertools
import json
import pathlib
import random

import pytest

from repro.dispatch import workloads
from repro.dispatch.placement import plan as j_plan
from repro.dispatch.schedule import make_schedule as j_make_schedule
from repro.dispatch.trace import fidelity as j_fidelity
from repro_torch import prim
from repro_torch.dispatch import PlanCache, batch_signature
from repro_torch.dispatch import workloads as t_workloads
from repro_torch.dispatch.graph import OpGraph, OpNode
from repro_torch.dispatch.placement import _resolve, evaluate, plan
from repro_torch.dispatch.schedule import TRANSFER_SETUP_S, make_schedule
from repro_torch.dispatch.trace import FIDELITY_BAND, fidelity
from test_golden_plans import _cases
from test_planner_properties import (RANKED_DEVICES, annotate_exchanges,
                                     make_chain)

REL = 1e-9
GOLDEN = json.loads((pathlib.Path(__file__).parent
                     / "golden_plans.json").read_text())
F1_SEED = 327063163


# ------------------------------------------------------------------ #
# reference graphs -> JSON -> the port's OpGraph
# ------------------------------------------------------------------ #

def graph_doc(g) -> dict:
    """A reference `OpGraph` as a JSON document (node order, edge order
    and every planner input kept; a node's compiled analysis dropped)."""
    return json.loads(json.dumps({
        "name": g.name, "input_bytes": g.input_bytes,
        "nodes": [{"name": n.name, "kind": n.kind, "flops": n.flops,
                   "hbm_bytes": n.hbm_bytes, "out_bytes": n.out_bytes,
                   "ops": [[op, dt, c] for (op, dt), c in n.ops.items()],
                   "exchange_bytes": n.exchange_bytes,
                   "meta": {k: v for k, v in n.meta.items()
                            if k != "analysis"}}
                  for n in g.nodes.values()],
        "edges": [list(e) for e in g.edges],
        "exchange_edges": [[u, v, b]
                           for (u, v), b in g.exchange_edges.items()]}))


def port_graph(doc: dict) -> OpGraph:
    g = OpGraph(doc["name"], input_bytes=doc["input_bytes"])
    for n in doc["nodes"]:
        g.nodes[n["name"]] = OpNode(
            name=n["name"], kind=n["kind"], flops=n["flops"],
            hbm_bytes=n["hbm_bytes"], out_bytes=n["out_bytes"],
            ops={(op, dt): c for op, dt, c in n["ops"]},
            exchange_bytes=n["exchange_bytes"], meta=dict(n["meta"]))
    g.edges = [tuple(e) for e in doc["edges"]]
    g.exchange_edges = {(u, v): b for u, v, b in doc["exchange_edges"]}
    return g


@functools.cache
def reference_graph(name):
    build, devices = workloads.shipped_graphs()[name]
    return build(), tuple(devices)


def snapshot(graph, planner, scheduler, devices, objective) -> dict:
    """`tests/test_golden_plans.py::_snapshot` of one planner's plan."""
    p = planner(graph, devices=devices, objective=objective)
    order = graph.topo_order()
    sched = scheduler(graph, p, pipelined=True)
    return {"method": p.method, "objective": p.objective,
            "placement": [[n, p.assignment[n]] for n in order],
            "stage_boundaries": [
                i for i in range(1, len(order))
                if p.assignment[order[i]] != p.assignment[order[i - 1]]],
            "groups": [[g.device, len(g.nodes)] for g in sched.groups],
            "overlapped_s": sched.overlapped_s,
            "pipelined_s": sched.pipelined_s}


def check_case(case: str) -> None:
    """The port's plan of one golden case equals the reference planner's
    on the same (reference-built) graph. Under the serial objective (one
    case per shipped graph) the planner-fidelity gate of
    tests/test_trace.py runs on both: the port's plan replays its own
    modelled trace within FIDELITY_BAND, at the reference's times."""
    name, objective = _cases()[case]
    g, devices = reference_graph(name)
    tg = port_graph(graph_doc(g))
    want = snapshot(g, j_plan, j_make_schedule, devices, objective)
    got = snapshot(tg, plan, make_schedule, devices, objective)
    for key in ("method", "objective", "placement", "stage_boundaries",
                "groups"):
        assert got[key] == want[key], key
    for key in ("overlapped_s", "pipelined_s"):
        assert got[key] == pytest.approx(want[key], rel=REL), key
    if objective == "serial":
        rep = fidelity(tg, plan(tg, devices=devices))
        ref = j_fidelity(g, j_plan(g, devices=devices))
        assert rep.ok and rep.band == FIDELITY_BAND, rep.render()
        assert rep.replayed_s == pytest.approx(ref.replayed_s, rel=REL)
        assert rep.predicted_s == pytest.approx(ref.predicted_s, rel=REL)


#: the cases this file plans; the MoE and sliding-window graphs have
#: their own files
MOE_GRAPHS = ("lm-moe-prefill-dag", "lm-moe-prefill-dag-reduced",
              "lm-moe-decode-dag-int8", "lm-moe-decode-dag-int8-reduced",
              "lm-moe-prefill-dag-int8", "lm-moe-prefill-dag-int8-reduced",
              "lm-moe-decode-dag-reduced-ep2",
              "lm-moe-decode-dag-int8-reduced-ep4",
              "lm-decode-steps-dag-reduced",
              "lm-moe-decode-steps-int8-reduced")
SWA_GRAPHS = ("lm-decode-dag-swa4096", "lm-decode-dag-swa8-reduced",
              "lm-moe-decode-dag-int8-swa4096",
              "lm-moe-decode-dag-int8-swa8-reduced",
              "lm-prefill-dag-swa4096-32k", "lm-prefill-dag-swa8-reduced")


#: the longest case (branch-and-bound over 517 nodes, ~11 s a planner)
#: has a file of its own
LONG_CASE = "lm-prefill-dag-swa4096-32k@overlapped"


def cases_of(graphs) -> list:
    return sorted(c for c, (g, _) in _cases().items()
                  if g in graphs and c != LONG_CASE)


CASES = sorted(c for c, (g, _) in _cases().items()
               if g not in MOE_GRAPHS + SWA_GRAPHS)


def test_every_golden_case_is_planned_once():
    planned = (CASES + cases_of(MOE_GRAPHS) + cases_of(SWA_GRAPHS)
               + [LONG_CASE])
    assert sorted(planned) == sorted(_cases()) and len(planned) == 61


@pytest.mark.parametrize("case", CASES)
def test_plan_equals_the_reference_planner(case):
    check_case(case)


def test_graph_round_trip_keeps_every_planner_input():
    g, _ = reference_graph("lm-prefill-dag-reduced")
    tg = port_graph(graph_doc(g))
    assert list(tg.nodes) == list(g.nodes)
    assert tg.edges == g.edges and tg.exchange_edges == g.exchange_edges
    assert tg.topo_order() == g.topo_order()
    assert tg.max_frontier() == g.max_frontier()
    assert tg.total_flops == g.total_flops
    assert tg.total_bytes == g.total_bytes
    for n in g.nodes:
        a, b = tg.nodes[n], g.nodes[n]
        assert (a.oi, a.complex_frac, a.comm_ratio) == \
            (b.oi, b.complex_frac, b.comm_ratio)
        assert a.pim_suitable(0.5) == b.pim_suitable(0.5)


# ------------------------------------------------------------------ #
# the port's own PrIM graphs against the goldens
# ------------------------------------------------------------------ #

PRIM_DEVICES = ("xeon", "titan_v", "upmem_2556")


@pytest.mark.parametrize("counts", prim.all_ref_counts(),
                         ids=lambda c: c.name)
def test_prim_graph_matches_golden(counts):
    g = t_workloads.prim_graph(counts)
    want = GOLDEN[f"prim/{counts.name}"]
    assert want["devices"] == list(PRIM_DEVICES)
    got = snapshot(g, plan, make_schedule, PRIM_DEVICES, "serial")
    assert got["placement"] == want["placement"]
    assert got["method"] == want["method"]
    assert got["objective"] == want["objective"]
    assert got["stage_boundaries"] == want["stage_boundaries"]
    assert got["groups"] == want["schedule"]["groups"]
    for key in ("overlapped_s", "pipelined_s"):
        assert got[key] == pytest.approx(want["schedule"][key], rel=1e-6)


# ------------------------------------------------------------------ #
# F1: the dp-overlap rung reports the cost of the schedule it plans
# ------------------------------------------------------------------ #

def _ranked_chain(seed):
    """The ranked chain of `tests/test_planner_properties.py` for `seed`:
    the Hypothesis test's form for F1_SEED (4 nodes at most, a fresh
    generator for the exchanges), the seeded sweep's otherwise."""
    if seed == F1_SEED:
        g = annotate_exchanges(make_chain(random.Random(seed), max_nodes=4),
                               random.Random(seed))
    else:
        rng = random.Random(seed)
        g = annotate_exchanges(make_chain(rng, max_nodes=5), rng)
    return g


def _brute_force_overlapped(g, device_set):
    devices, dpu = _resolve(device_set)
    names = list(g.nodes)
    return min(
        make_schedule(g, evaluate(g, dict(zip(names, combo)), dpu),
                      dpu).overlapped_s
        for combo in itertools.product(devices, repeat=len(names)))


@pytest.mark.parametrize("seed", [F1_SEED] + list(range(19_000, 19_012)))
def test_ranked_chain_overlapped_dp_reports_its_schedule(seed):
    """On ranked chains (two ranks of one UPMEM system) a crossing from one
    rank to the other is two transfer calls, a retrieve and a push, as
    `make_schedule` books it; the reference's DP books one and
    under-reports its own cost by TRANSFER_SETUP_S (F1)."""
    g = port_graph(graph_doc(_ranked_chain(seed)))
    p = plan(g, devices=RANKED_DEVICES, objective="overlapped")
    assert p.method == "dp-overlap" and p.objective == "overlapped"
    devices, dpu = _resolve(RANKED_DEVICES)
    assert p.overlapped_s == pytest.approx(
        make_schedule(g, p, dpu).overlapped_s, rel=REL)
    assert p.overlapped_s == pytest.approx(
        _brute_force_overlapped(g, RANKED_DEVICES), rel=REL)


def test_f1_case_reference_under_reports_by_one_setup():
    jg = _ranked_chain(F1_SEED)
    jp = j_plan(jg, devices=RANKED_DEVICES, objective="overlapped")
    tg = port_graph(graph_doc(jg))
    tp = plan(tg, devices=RANKED_DEVICES, objective="overlapped")
    assert tp.assignment == jp.assignment
    assert tp.overlapped_s - jp.overlapped_s == pytest.approx(
        TRANSFER_SETUP_S, rel=1e-6)
    assert tp.overlapped_s == pytest.approx(0.0549763, rel=1e-6)


# ------------------------------------------------------------------ #
# the plan cache
# ------------------------------------------------------------------ #

def test_plan_cache_hits_misses_and_evictions():
    """A seeded stream of serving batch signatures (slots joining and
    leaving, positions advancing, prefill grids) through an LRU of 4:
    hits, misses and evictions equal a plain LRU model of the stream, and
    each miss builds exactly once."""
    rng = random.Random(7)
    cache, model, built = PlanCache(maxsize=4), [], []
    stats = {"hits": 0, "misses": 0, "evictions": 0}
    pos = [0, 0, 0]
    for _ in range(300):
        if rng.random() < 0.2:
            key = batch_signature(1, splits=(rng.choice((4, 8)), 2),
                                  phase="prefill")
        else:
            pos = [p + rng.randint(0, 9) for p in pos]
            live = rng.randint(1, 3)
            key = batch_signature(live, pos[:live], pos_bucket=32)
        val = cache.get_or_plan(key, lambda k=key: built.append(k) or k)
        assert val == key
        if key in model:
            stats["hits"] += 1
            model.remove(key)
        else:
            stats["misses"] += 1
            if len(model) == 4:
                model.pop(0)
                stats["evictions"] += 1
        model.append(key)
        assert key in cache and len(cache) == len(model)
    got = cache.stats
    assert {k: got[k] for k in stats} == stats
    assert got["calls"] == 300 and len(built) == stats["misses"]
    assert got["hit_rate"] == stats["hits"] / 300
    assert stats["hits"] and stats["evictions"]
    with pytest.raises(ValueError):
        PlanCache(maxsize=0)
    with pytest.raises(ValueError):
        batch_signature(1, (), pos_bucket=0)
