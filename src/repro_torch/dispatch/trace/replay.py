"""Trace replay: re-price a recorded timeline under the pipelined
event-sim discipline, and gate planner fidelity on the result.

A copy of `repro.dispatch.trace.replay`, kept in the port because the port
imports nothing of `repro`; it uses no framework.

The replayer's contract is the methodology profiling-replay systems use
for distributed training (record once on real hardware, then re-simulate
the dependency graph under a queue-per-resource discipline to price
what-ifs): a trace fixes WHAT ran — the executed node linearization and
the device assignment — and `make_schedule(..., pipelined=True)` re-prices
WHEN, with every device a serial queue and all host<->device traffic on
ONE shared transfer channel (DESIGN.md §13). Because prices come from the
cost model, a replay can swap the hardware out from under a recorded run:
`replay(trace, graph, dpu=what_if(channel_scale=2.0))` prices the same
execution on a machine with a doubled transfer channel without running
it.

`fidelity` is the planner-fidelity gate's primitive: the planner's
predicted `Schedule.pipelined_s` must stay within `FIDELITY_BAND`
relative error of the replayed trace — drift between what the planner
promises and what the executed timeline re-prices to fails CI the same
way golden-plan drift does. All times are seconds.
"""

from __future__ import annotations

import dataclasses

from ...core.pim_model import DPUModel, UPMEM_2556
from ..graph import OpGraph
from ..placement import Plan
from ..schedule import Schedule, make_schedule
from .events import Trace

#: the documented relative-error band of the planner-fidelity gate:
#: |replayed - predicted| / predicted must stay inside it for every
#: shipped golden graph (tests/test_trace.py, the CI fidelity-gate step)
FIDELITY_BAND = 0.10


def modeled_trace(graph: OpGraph, plan: Plan, dpu: DPUModel | None = None,
                  *, source: str = "xeon", sink: str = "xeon",
                  order: list | None = None,
                  node_times: dict | None = None) -> Trace:
    """Run the pipelined event simulation and capture its timeline as a
    `Trace` — the modeled twin of a measured executor trace (same event
    schema, timestamps in cost-model seconds instead of wall-clock)."""
    events: list[dict] = []
    sched = make_schedule(graph, plan, dpu, source, sink, pipelined=True,
                          order=order, node_times=node_times, events=events)
    t = Trace(name=f"{graph.name}:modeled")
    t.meta.update(modeled=True, graph=graph.name,
                  assignment=dict(plan.assignment),
                  pipelined_s=sched.pipelined_s)
    for ev in events:
        t.add(ev["kind"], ev["name"], ev["resource"], ev["t0"], ev["t1"],
              group=ev["group"], **ev["attrs"])
    return t


def executed_order(trace: Trace) -> list[str]:
    """The node linearization a trace records: compute-event names in
    recorded order (the executor appends them as it dispatches, so this
    is the order that actually ran)."""
    return [e.name for e in trace.events if e.kind == "compute"]


def measured_node_times(trace: Trace) -> dict:
    """Per-node compute seconds a trace measured (name -> seconds; the
    last recorded span per node wins, i.e. post-warmup steps of a
    multi-step serving trace)."""
    out: dict = {}
    for e in trace.events:
        if e.kind == "compute":
            out[e.name] = e.dur_s
    return out


def what_if(dpu: DPUModel | None = None, *, n_dpus: int | None = None,
            mram_bw: float | None = None,
            launch_overhead_s: float | None = None,
            channel_scale: float | None = None) -> DPUModel:
    """A hypothetical UPMEM system for what-if replay: start from `dpu`
    (default the 2556-DPU system) and override fields; `channel_scale`
    multiplies BOTH host<->DPU channel bandwidths (bytes/s) — 'what if
    the transfer channel were 2x faster' is `channel_scale=2.0`."""
    base = dpu or UPMEM_2556
    kw: dict = {}
    if n_dpus is not None:
        kw["n_dpus"] = n_dpus
    if mram_bw is not None:
        kw["mram_bw"] = mram_bw
    if launch_overhead_s is not None:
        kw["launch_overhead_s"] = launch_overhead_s
    if channel_scale is not None:
        kw["host_to_dpu_bw"] = base.host_to_dpu_bw * channel_scale
        kw["dpu_to_host_bw"] = base.dpu_to_host_bw * channel_scale
    return dataclasses.replace(base, **kw)


@dataclasses.dataclass
class ReplayResult:
    """A re-priced timeline: the replayed linearization, the full
    re-priced `Schedule`, and its pipelined makespan in seconds."""

    graph_name: str
    order: list
    schedule: Schedule
    total_s: float


def replay(trace: Trace, graph: OpGraph, assignment: dict | None = None,
           *, dpu: DPUModel | None = None, source: str = "xeon",
           sink: str = "xeon", use_measured_times: bool = False) -> \
        ReplayResult:
    """Re-price a recorded timeline under the pipelined event-sim
    discipline (each device a serial queue, one shared transfer channel).

    The trace supplies the executed linearization (`executed_order`) and,
    via `trace.meta["assignment"]` when `assignment` is None, the device
    placement; `make_schedule(..., pipelined=True, order=...)` re-prices
    it. A multi-step serving trace (node names repeating once per decode
    step) replays its LAST step — the post-warmup steady state. Pass a
    what-if `dpu` (see `what_if`) to price the same execution on
    different hardware; `use_measured_times=True` prices compute with the
    trace's measured spans instead of the cost model (channel traffic
    stays modeled)."""
    assignment = assignment or trace.meta.get("assignment")
    if not assignment:
        raise ValueError("no assignment: pass one or record it in "
                         "trace.meta['assignment']")
    order = executed_order(trace)
    n = len(graph.nodes)
    if len(order) > n:
        order = order[-n:]          # multi-step trace: replay the last step
    if sorted(order) != sorted(graph.nodes):
        order = []                  # partial/mixed trace (e.g. prefill
                                    # spans of another DAG): planner order
    node_times = measured_node_times(trace) if use_measured_times else None
    sched = make_schedule(graph, Plan.stub(graph.name, assignment,
                                           method="replay"),
                          dpu, source, sink, pipelined=True,
                          order=order or None, node_times=node_times)
    return ReplayResult(graph_name=graph.name, order=list(order),
                        schedule=sched, total_s=sched.pipelined_s)


@dataclasses.dataclass
class FidelityReport:
    """Predicted-vs-replayed comparison for one graph (seconds): the
    planner's `pipelined_s` prediction, the trace-replayed makespan, and
    the gate band the comparison is judged against."""

    graph_name: str
    predicted_s: float
    replayed_s: float
    band: float = FIDELITY_BAND

    @property
    def rel_err(self) -> float:
        """|replayed - predicted| / predicted — the gated quantity."""
        return abs(self.replayed_s - self.predicted_s) / self.predicted_s

    @property
    def ok(self) -> bool:
        """True when the relative error sits inside the gate's band."""
        return self.rel_err <= self.band

    def render(self) -> str:
        """One human-readable gate line (ms, err %, PASS/FAIL)."""
        return (f"fidelity[{self.graph_name}] predicted "
                f"{self.predicted_s * 1e3:.3f}ms vs replayed "
                f"{self.replayed_s * 1e3:.3f}ms: err "
                f"{self.rel_err * 100.0:.2f}% "
                f"({'PASS' if self.ok else 'FAIL'} @ {self.band:.0%})")


def fidelity(graph: OpGraph, plan: Plan, *, trace: Trace | None = None,
             dpu: DPUModel | None = None, source: str = "xeon",
             sink: str = "xeon", band: float = FIDELITY_BAND) -> \
        FidelityReport:
    """The planner-fidelity gate's primitive: compare the plan's
    predicted `Schedule.pipelined_s` against the re-priced replay of an
    execution trace. With `trace=None` the plan's own modeled trace is
    replayed (the record->replay round trip — drift means the replayer
    and the simulation disagree); pass a MEASURED executor trace to gate
    the planner against the order/assignment that actually ran (drift
    means the executor diverged from the planned timeline)."""
    predicted = make_schedule(graph, plan, dpu, source, sink,
                              pipelined=True).pipelined_s
    tr = trace if trace is not None else \
        modeled_trace(graph, plan, dpu, source=source, sink=sink)
    rep = replay(tr, graph, plan.assignment, dpu=dpu, source=source,
                 sink=sink)
    return FidelityReport(graph_name=graph.name, predicted_s=predicted,
                          replayed_s=rep.total_s, band=band)
