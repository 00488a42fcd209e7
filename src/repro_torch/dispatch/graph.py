"""Operator graphs for offload planning.

An `OpGraph` is the unit the placement planner works on: nodes carry the
per-operator quantities the paper's takeaways are phrased in — flops, bytes
moved, operational intensity, op mix (simple vs mul/div/float vs
transcendental), and the inter-bank traffic the op would generate if it ran
bank-parallel on PIM. Edges carry the bytes that flow between operators,
i.e. what a host<->DPU boundary crossing costs if the two ends are placed
on different devices.

Two granularities:

  * `OpGraph.from_program(fn, *args)` — one node per costed unit of the
    program's census (a fused elementwise group, a matrix product, a
    memory op), with edges along the data flow between units. Used for
    inspecting real steps.
  * `node_from_fn(name, fn, *args)` — one node per *stage* of a dispatch
    pipeline, costed by tracing the stage alone on fake tensors and
    counting it with `core.census`. This is the granularity the runtime
    can actually execute, so it is what the planner and scheduler consume.

Per-element op counts (`OpNode.ops`, keyed like `pim_model.DPU_OP_COST`)
are extracted by `ops_from_program`, which charges every arithmetic op at
output-element granularity (reductions per input element, products per
multiply-add pair) — the quantity `DPUModel.compute_time` wants.

The port of `repro.dispatch.graph`: the reference parses XLA HLO text
(`ops_from_hlo`, `from_hlo`); here `core.census` counts the aten ops of
a trace, with the same op and dtype classes. `OpNode`, `OpGraph` and the
annotations are copied unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable

from ..core import census
from ..core.suitability import COMM_RATIO_THRESHOLD, COMPLEX_FRAC_THRESHOLD

_SIMPLE_CLASSES = {"add", "sub", "bitwise", "compare"}
_COMPLEX_CLASSES = {"mul", "div", "transc"}


def ops_from_program(fn_or_program, *example_args
                     ) -> dict[tuple[str, str], float]:
    """Per-element arithmetic op counts {(op, dtype): n} of a program — the
    operand `DPUModel.compute_time` consumes. Takes a recorded
    `census.Program`, or a function and example arguments to trace.
    Products are decomposed into mul+add pairs over their contraction;
    loops are unrolled in the trace, so the counts are exact."""
    prog = (fn_or_program if isinstance(fn_or_program, census.Program)
            else census.trace_program(fn_or_program, *example_args))
    return census.analyze(prog).ops


# ---------------------------------------------------------------------------
# nodes and graphs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class OpNode:
    """One schedulable operator: the quantities KT1-3 are phrased in."""
    name: str
    kind: str                          # opcode / stage kind label
    flops: float                       # host-style flop count
    hbm_bytes: float                   # device-local memory traffic
    out_bytes: float                   # bytes handed to each consumer
    ops: dict = dataclasses.field(default_factory=dict)
    exchange_bytes: float = 0.0        # inter-bank bytes if run on PIM (KT3)
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def oi(self) -> float:
        """Operational intensity, flop/byte (KT1)."""
        return self.flops / self.hbm_bytes if self.hbm_bytes else float("inf")

    @property
    def complex_frac(self) -> float:
        """Fraction of arithmetic that is mul/div/transcendental (KT2)."""
        simple = sum(n for (op, _), n in self.ops.items()
                     if op in _SIMPLE_CLASSES)
        cplx = sum(n for (op, _), n in self.ops.items()
                   if op in _COMPLEX_CLASSES)
        total = simple + cplx
        return cplx / total if total else 0.0

    @property
    def comm_ratio(self) -> float:
        """Inter-bank bytes per local byte (KT3)."""
        return (self.exchange_bytes / self.hbm_bytes
                if self.hbm_bytes else 0.0)

    def pim_suitable(self, balance: float) -> bool:
        """The paper's three-way verdict for this single operator."""
        return (self.oi < balance
                and self.complex_frac < COMPLEX_FRAC_THRESHOLD
                and self.comm_ratio < COMM_RATIO_THRESHOLD)


@dataclasses.dataclass
class OpGraph:
    """A DAG of OpNodes; edges carry the producer's out_bytes.

    `exchange_edges` marks a subset of edges as *exchange phases*: the
    producer's tensor is not merely handed to the consumer, it must be
    RE-DISTRIBUTED across PIM banks (an MoE token dispatch/combine, a
    transpose's all-to-all). There is no inter-DPU channel (Takeaway 3),
    so when both endpoints sit on the same UPMEM system the bytes still
    round-trip through host DRAM — `placement.exchange_time` charges it,
    `schedule.py` books it as transfer-channel-only occupancy, and
    `dispatch.executor.PlanExecutor` executes it as a host gather/scatter
    stage. On one host-class device the exchange is a local shuffle
    (free beyond the node's own memory traffic); across devices the
    ordinary boundary transfer already relays through the host."""
    name: str
    nodes: dict[str, OpNode] = dataclasses.field(default_factory=dict)
    edges: list[tuple[str, str]] = dataclasses.field(default_factory=list)
    input_bytes: float = 0.0           # bytes entering the graph from host
    #: (producer, consumer) -> bytes re-distributed across banks
    exchange_edges: dict[tuple[str, str], float] = dataclasses.field(
        default_factory=dict)

    def add(self, node: OpNode, *preds: str) -> OpNode:
        """Insert `node` with edges from the named predecessors."""
        self.nodes[node.name] = node
        for p in preds:
            self.edges.append((p, node.name))
        return node

    def annotate_exchange(self, u: str, v: str, nbytes: float) -> None:
        """Mark existing edge (u, v) as an exchange phase moving `nbytes`
        across banks (the first-class exchange-edge annotation). The
        volume is the caller's to model — for MoE token routing it scales
        with tokens x capacity (`workloads.moe_exchange_bytes`), NOT with
        the expert count: only dispatched rows travel, empty capacity
        slots do not."""
        if (u, v) not in set(self.edges):
            raise ValueError(f"no edge {u!r}->{v!r} in graph {self.name}")
        self.exchange_edges[(u, v)] = float(nbytes)

    def _derived(self) -> dict:
        """Adjacency/topo structures, memoized per (node, edge) count —
        planners and the overlapped-objective search re-read these many
        times per plan (do NOT mutate the returned dicts; `add` is the
        only supported mutation and invalidates by changing the counts)."""
        key = (len(self.nodes), len(self.edges))
        cached = getattr(self, "_dcache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        preds: dict[str, list[str]] = {n: [] for n in self.nodes}
        succs: dict[str, list[str]] = {n: [] for n in self.nodes}
        for u, v in self.edges:
            preds[v].append(u)
            succs[u].append(v)
        pending = {n: set(ps) for n, ps in preds.items()}
        order, ready = [], [n for n in self.nodes if not pending[n]]
        while ready:
            n = ready.pop(0)
            order.append(n)
            for s in succs[n]:
                pending[s].discard(n)
                if not pending[s]:
                    ready.append(s)
        if len(order) != len(self.nodes):
            raise ValueError(f"cycle in op graph {self.name}")
        d = {"preds": preds, "succs": succs, "topo": order}
        self._dcache = (key, d)
        return d

    @property
    def preds(self) -> dict[str, list[str]]:
        """node name -> list of predecessor names (edge sources)."""
        return self._derived()["preds"]

    @property
    def succs(self) -> dict[str, list[str]]:
        """node name -> list of successor names (edge destinations)."""
        return self._derived()["succs"]

    def topo_order(self) -> list[str]:
        """Kahn topological order (FIFO ties); raises on cycles."""
        return list(self._derived()["topo"])

    def last_use_positions(self, order: list[str] | None = None
                           ) -> dict[str, int]:
        """Topo-order position of each producer's last consumer (-1 for
        leaves) — when the walk passes it, the producer's tensor is no
        longer awaited. Shared bookkeeping between `max_frontier` and the
        placement planner's frontier DP (`placement._DagWalk`), so the
        reported width and the DP's actual state space cannot drift."""
        order = order if order is not None else self.topo_order()
        pos = {n: i for i, n in enumerate(order)}
        return {u: max((pos[v] for v in ss), default=-1)
                for u, ss in self.succs.items()}

    def max_frontier(self) -> int:
        """Largest number of already-visited producers still awaited by an
        unvisited consumer at any point of the topological order. The
        frontier DP's state space is exponential in this width — chains
        and stars are 1, the decode DAG's residual braid is 2, wide
        parallel compositions grow with their branch count."""
        order = self.topo_order()
        preds, succs = self.preds, self.succs
        last_use = self.last_use_positions(order)
        open_now, widest = set(), 0
        for i, n in enumerate(order):
            for u in preds[n]:
                if last_use[u] == i:
                    open_now.discard(u)
            if succs[n]:
                open_now.add(n)
            widest = max(widest, len(open_now))
        return widest

    @property
    def is_chain(self) -> bool:
        """True when the graph is a linear chain (the chain DP's case)."""
        if len(self.edges) != len(self.nodes) - 1:
            return False
        return (all(len(p) <= 1 for p in self.preds.values())
                and all(len(s) <= 1 for s in self.succs.values()))

    def chain(self) -> list[str]:
        """The chain's node order; asserts the graph IS a chain."""
        assert self.is_chain, f"{self.name} is not a chain"
        return self.topo_order()

    @property
    def total_flops(self) -> float:
        """Sum of per-node host-style flop counts."""
        return sum(n.flops for n in self.nodes.values())

    @property
    def total_bytes(self) -> float:
        """Sum of per-node device-local memory traffic (bytes)."""
        return sum(n.hbm_bytes for n in self.nodes.values())

    # -----------------------------------------------------------------
    # builders
    # -----------------------------------------------------------------

    @classmethod
    def from_program(cls, fn: Callable, *example_args,
                     name: str = "program") -> "OpGraph":
        """Fine-grained graph: one node per costed unit of the program's
        census (fused groups stay whole), edges along the data flow."""
        prog = census.trace_program(fn, *example_args)
        g = cls(name)
        for u in census.program_units(prog):
            node = OpNode(name=u.name, kind=u.kind, flops=u.flops,
                          hbm_bytes=u.hbm_bytes, out_bytes=u.out_bytes,
                          ops=dict(u.counts))
            g.add(node, *[p.name for p in u.preds if p.name in g.nodes])
        g.input_bytes = float(sum(v.nbytes for v in prog.inputs))
        return g


# ---------------------------------------------------------------------------
# stage-level node builder (what the runtime executes)
# ---------------------------------------------------------------------------

def node_from_fn(name: str, fn: Callable, *example_args,
                 kind: str = "stage", exchange_bytes: float = 0.0) -> OpNode:
    """Trace `fn` on example args (tensors on any device, or fake ones —
    nothing runs on the card) and cost it as one OpNode via the census;
    `out_bytes` counts the bytes of every tensor `fn` returns."""
    return node_from_program(name, census.trace_program(fn, *example_args),
                             kind=kind, exchange_bytes=exchange_bytes)


def node_from_program(name: str, prog: census.Program, *,
                      kind: str = "stage",
                      exchange_bytes: float = 0.0) -> OpNode:
    """`node_from_fn` of an already recorded program (`census.
    trace_program`), for callers that also read its outputs' shapes."""
    analysis = census.analyze(prog)
    return OpNode(
        name=name, kind=kind,
        flops=analysis.flops,
        hbm_bytes=analysis.hbm_bytes,
        out_bytes=float(sum(v.nbytes for v in prog.outputs)),
        ops=dict(analysis.ops),
        exchange_bytes=exchange_bytes,
        meta={"analysis": analysis},
    )


def annotate_kv_residency(node: OpNode, kv_bytes: float,
                          home: str) -> OpNode:
    """Mark a node as reading `kv_bytes` (bytes) of cache resident on
    `home` (a `placement.DEVICES` name). The planner
    (`placement.kv_migration_time`) charges moving those bytes over the
    measured channel whenever the node is placed elsewhere — the
    data-placement term of the decode/prefill DAG objectives."""
    node.meta["kv_bytes"] = float(kv_bytes)
    node.meta["kv_home"] = home
    return node


def annotate_kv_write(node: OpNode, kv_bytes: float, home: str) -> OpNode:
    """Mark a node as *writing* `kv_bytes` (bytes) of KV-cache rows whose
    residency is `home` (a `placement.DEVICES` name). Placing the node on
    any other device charges shipping the freshly produced rows back to the
    home over the measured channel (`placement.kv_migration_time`'s
    write-back term) — the cost a chunked prefill pays to keep the cache
    bank-resident while its compute runs elsewhere."""
    node.meta["kv_write_bytes"] = float(kv_bytes)
    node.meta["kv_write_home"] = home
    return node


def chain_graph(name: str, nodes: Iterable[OpNode],
                input_bytes: float = 0.0) -> OpGraph:
    """Link nodes into a linear chain (the common pipeline shape)."""
    g = OpGraph(name, input_bytes=input_bytes)
    prev: str | None = None
    for node in nodes:
        g.add(node, *( [prev] if prev else [] ))
        prev = node.name
    return g
