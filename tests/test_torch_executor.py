"""The port's plan executor (`repro_torch.dispatch.executor`) against the
reference's.

The executed launch-group order equals the reference executor's for the
same graph and assignment (decode, prefill and MoE skeletons, planned
and forced); the environment drops a node's output after its last
consumer's group and keeps what `keep` names; `FaceCache.stats` counts
calls, builds ("compiles": a face's first call at a new shape
signature) and hits per face and kind; a PIM-placed call whose bank axis
does not divide over the banks runs the host face and is counted; the
PIM face of a row-wise stage gives the host face's bits at 1, 2 and 4
banks; `tracer=` records the reference's span kinds."""

import pytest
import torch

from repro.dispatch import workloads as j_workloads
from repro.dispatch.executor import FaceCache as JFaceCache
from repro.dispatch.executor import PlanExecutor as JPlanExecutor
from repro.dispatch.executor import StageDef as JStageDef
from repro_torch.core.bank_parallel import BankGrid
from repro_torch.dispatch import workloads
from repro_torch.dispatch.executor import FaceCache, PlanExecutor, StageDef
from repro_torch.dispatch.graph import OpGraph, OpNode
from repro_torch.dispatch.trace import Trace

KINDS = ("embed", "qkv", "attn", "o", "mlp", "router", "expert", "combine",
         "head")


def _executors(jg, tg, assignment, jgrid):
    jfaces = JFaceCache([JStageDef(k, lambda x: x, (0,), (0,))
                         for k in KINDS], jgrid)
    tfaces = FaceCache([StageDef(k, lambda x: x, (0,), (0,))
                        for k in KINDS], BankGrid(1, "cpu"))
    return (JPlanExecutor(jg, assignment, jfaces),
            PlanExecutor(tg, assignment, tfaces))


def _mixed(graph, every=3, pim="upmem_2556"):
    """A forced assignment alternating devices along the topo order."""
    return {n: (pim if i % every == 0 else "xeon")
            for i, n in enumerate(graph.topo_order())}


@pytest.mark.parametrize("build", [
    lambda w: w.prefill_dag(w.REDUCED_DIMS, prefill_len=11, chunk=4,
                            costed=False),
    lambda w: w.prefill_dag(w.MOE_REDUCED_DIMS, prefill_len=8, chunk=4,
                            costed=False),
    lambda w: w.prefill_dag(w.SWA_REDUCED_DIMS, prefill_len=16, chunk=4,
                            costed=False),
    lambda w: w.decode_dag(w.REDUCED_DIMS),
    lambda w: w.decode_dag(w.MOE_REDUCED_DIMS, expert_shards=2),
], ids=["prefill", "moe-prefill", "swa-prefill", "decode", "moe-ep2"])
def test_executed_order_equals_the_reference(build, bank_grid):
    jg, tg = build(j_workloads), build(workloads)
    for assignment in (_mixed(jg), _mixed(jg, 2),
                       {n: "xeon" for n in jg.nodes},
                       {n: "upmem_2556" for n in jg.nodes}):
        je, te = _executors(jg, tg, assignment, bank_grid)
        assert te.executed_order() == je.executed_order()
        assert te._exchange_in == je._exchange_in
        assert te._dead_after == je._dead_after


def _chain3():
    g = OpGraph("tiny", input_bytes=4.0)
    for name, preds in (("a", ()), ("b", ("a",)), ("c", ("b",))):
        g.add(OpNode(name, "f", flops=1.0, hbm_bytes=4.0, out_bytes=4.0),
              *preds)
    return g


def test_executor_frees_dead_env_entries():
    """tests/test_dispatch.py's case: `run` drops a node's output once its
    last consumer group has dispatched, keeping what `keep` names."""
    faces = FaceCache([StageDef("f", lambda x: x + 1, (0,), (0,))],
                      BankGrid(1, "cpu"))
    ex = PlanExecutor(_chain3(), {"a": "xeon", "b": "xeon", "c": "xeon"},
                      faces, kind_of=lambda n: "f")

    def bind(name, env):
        prev = {"b": "a", "c": "b"}.get(name)
        return (env[prev],) if prev else (torch.zeros(2),)

    env = ex.run(bind, keep={"c"})
    assert set(env) == {"c"}
    env = ex.run(bind, keep={"a", "c"})
    assert set(env) == {"a", "c"}
    assert float(env["c"][0]) == 3.0


def test_off_graph_read_needs_keep():
    """An off-graph read (every layer's qkv reading embed's rope tables)
    fails once the producer is freed, and works when pinned by `keep` —
    the decode step's three-layer hybrid case."""
    g = OpGraph("offgraph")
    g.add(OpNode("e", "f", 1.0, 4.0, 4.0))
    g.add(OpNode("x", "f", 1.0, 4.0, 4.0), "e")
    g.add(OpNode("y", "f", 1.0, 4.0, 4.0), "x")
    faces = FaceCache([StageDef("f", lambda a, b: a + b, (0, 0), (0,))],
                      BankGrid(1, "cpu"))
    ex = PlanExecutor(g, {"e": "xeon", "x": "upmem_2556", "y": "xeon"},
                      faces, kind_of=lambda n: "f")

    def bind(name, env):
        if name == "e":
            return torch.ones(2), torch.ones(2)
        src = "e" if name == "x" else "x"
        return env[src], env["e"]          # y reads e off the graph

    with pytest.raises(KeyError):
        ex.run(bind)
    env = ex.run(bind, keep={"e", "y"})
    assert torch.equal(env["y"], torch.full((2,), 6.0))


def test_facecache_stats_count_builds_and_hits():
    """tests/test_dispatch.py's FaceCache case: one build per kind across
    repeated same-shape calls, hits after it, one more build per kind at a
    new shape, and duplicate kinds refused."""
    kinds = ("mlp", "router", "expert", "combine")
    faces = FaceCache([StageDef(k, lambda x: x + 1, (0,), (0,))
                       for k in kinds], BankGrid(2, "cpu"))
    x = torch.zeros(4)
    for _ in range(5):
        for k in kinds:
            faces.host(k)(x)
    st = faces.stats
    assert st["calls"] == 5 * len(kinds)
    assert st["compiles"] == len(kinds)
    assert st["hits"] == 4 * len(kinds)
    assert all(st["by_kind"][k] == {"calls": 5, "compiles": 1}
               for k in kinds)
    assert st["host"]["compiles"] == len(kinds) and \
        st["pim"]["compiles"] == 0
    for k in kinds:
        faces.host(k)(x)
    assert faces.stats["compiles"] == len(kinds)
    for k in kinds:
        faces.host(k)(torch.zeros(8))
        faces.pim(k)(torch.zeros(8))
    st = faces.stats
    assert st["compiles"] == 3 * len(kinds)
    assert st["pim"] == {"calls": len(kinds), "compiles": len(kinds)}
    with pytest.raises(ValueError, match="duplicate"):
        FaceCache([StageDef("mlp", lambda x: x + 1, (0,), (0,)),
                   StageDef("mlp", lambda x: x + 2, (0,), (0,))],
                  BankGrid(1, "cpu"))


def _rowwise(x, w, ids):
    return x @ w, ids * 2


@pytest.mark.parametrize("n_banks", (1, 2, 4))
def test_pim_face_gives_the_host_face_bits(n_banks):
    """A row-wise stage's PIM face (rows on axis 1 split over the banks,
    the weight replicated) is one call over the stacked banks: the host
    face's bits at any bank count, outputs merged along their axes."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 64, generator=g)
    w = torch.randn(64, 48, generator=g)
    ids = torch.arange(8)
    faces = FaceCache([StageDef("s", _rowwise, (1, None, 0), (1, 0))],
                      BankGrid(n_banks, "cpu"))
    host = faces.host("s")(x, w, ids)
    pim = faces.pim("s")(x, w, ids)
    assert all(torch.equal(a, b) for a, b in zip(host, pim))
    assert faces.pim_ok("s", (x, w, ids))


def test_ragged_chunk_falls_back_to_the_host_face():
    """A PIM-placed stage whose rows do not divide over the banks runs the
    host face, and the fallback is counted per kind."""
    g = OpGraph("ragged")
    g.add(OpNode("s0", "s", 1.0, 4.0, 4.0))
    g.add(OpNode("s1", "s", 1.0, 4.0, 4.0), "s0")
    faces = FaceCache([StageDef("s", lambda x: x * 2, (1,), (1,))],
                      BankGrid(4, "cpu"))
    ex = PlanExecutor(g, {"s0": "upmem_2556", "s1": "upmem_2556"}, faces,
                      kind_of=lambda n: "s")
    rows = {"s0": torch.ones(1, 8), "s1": None}

    def bind(name, env):
        return (rows["s0"],) if name == "s0" else (env["s0"][:, :5],)

    env = ex.run(bind, keep={"s1"})
    assert env["s1"].shape == (1, 5)
    st = faces.stats
    assert st["pim"]["calls"] == 1 and st["host"]["calls"] == 1
    assert st["fallbacks"] == {"s": 1}


def test_tracer_records_the_reference_span_kinds():
    """`run(tracer=...)` records a compute span per node, a stage_in span
    per PIM group with producers, an exchange span per relayed MoE edge,
    and the FaceCache's compile / cache_hit events."""
    tg = workloads.decode_dag(workloads.MOE_REDUCED_DIMS)
    assignment = {n: "upmem_2556" if n.startswith(("expert", "router",
                                                   "combine")) else "xeon"
                  for n in tg.nodes}
    faces = FaceCache([StageDef(k, lambda *a: torch.zeros(2), (None,),
                                (None,)) for k in KINDS],
                      BankGrid(1, "cpu"))
    ex = PlanExecutor(tg, assignment, faces)
    tr = Trace("executor")
    ex.run(lambda name, env: (torch.zeros(2),), tracer=tr)
    kinds = {e.kind for e in tr.events}
    assert {"compute", "stage_in", "exchange", "compile",
            "cache_hit"} <= kinds
    assert len(tr.by_kind("compute")) == len(tg.nodes)
    assert len(tr.by_kind("exchange")) == 2 * workloads.MOE_REDUCED_DIMS \
        .n_layers
