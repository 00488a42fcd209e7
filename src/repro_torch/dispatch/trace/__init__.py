"""repro_torch.dispatch.trace — execution tracing, replay, and calibration
(a copy of `repro.dispatch.trace`; the executor and the serving engine
that record measured traces come with ROADMAP Queue 1 items 14b and 15).

The observability layer over the planner->schedule->executor spine
(DESIGN.md §13). Three pieces share one event schema (`events.Trace`,
versioned, JSON + Chrome `trace_event` export):

  * **record** — `PlanExecutor.run(..., tracer=Trace())` measures the
    executed timeline (compute spans per node, channel occupancy per
    staging/exchange, FaceCache compile-vs-hit); the serving engine
    layers each admission's and decode step's launch and sync seconds on
    top (`ServeEngine.attach_tracer`; always into the engine's bounded
    process-level trace, `serve.engine.RECENT`, when none is attached),
    and `span` marks named stretches of the serving path inside them,
    mirrored into `torch.profiler`'s timeline (`repro_torch.spans`).
  * **replay** — `replay.replay` re-prices a recorded linearization +
    assignment under the pipelined event-sim discipline (queue per
    device, ONE shared transfer channel), including on what-if hardware
    (`replay.what_if`); `replay.fidelity` gates the planner's predicted
    `pipelined_s` against the replayed makespan (`FIDELITY_BAND`).
  * **calibrate** — `calibrate.fit_trace` least-squares-fits the cost
    constants (`placement.cost_constants`) from measured spans and
    reports per-constant drift vs the Fig.-4 anchors.

Units everywhere: seconds and bytes; device names from
`placement.DEVICES` plus the pseudo-resources `"channel"`/`"engine"`.
"""

from ...spans import scope, span
from .events import EVENT_KINDS, TRACE_SCHEMA_VERSION, Trace, TraceEvent
from .replay import (FIDELITY_BAND, FidelityReport, ReplayResult,
                     executed_order, fidelity, measured_node_times,
                     modeled_trace, replay, what_if)
from .calibrate import (CalibrationReport, ConstantFit, anchor_trace,
                        fit_trace)
