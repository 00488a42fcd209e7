"""repro_torch.dispatch — the offload planner core (the ported part of
`repro.dispatch`).

The paper's central finding is that PIM suitability is *per-operator*, not
per-program (Takeaways 1-3, Fig. 4's two workload groups). This package
turns the one-shot analyses of `repro_torch.core` into a plan:

    graph      build an operator graph (flops / bytes / OI / op mix per op
               from `core.census`, KV-residency read AND write annotations
               on cache-touching nodes)
    placement  assign every op to xeon / titan_v / upmem_* minimizing
               modeled end-to-end latency (seconds): chain DP -> exact
               frontier DP -> bounded branch-and-bound -> greedy, under
               the serial or the overlapped objective
    schedule   coalesce consecutive PIM stages into one launch, batch
               parallel transfers, overlap compute with transfers; serial
               groups (`overlapped_s`) and the dependency-aware pipeline
               (`pipelined_s`)
    plan_cache LRU cache of planner products keyed by batch signature
    trace      modeled execution traces (JSON + Chrome trace_event), the
               what-if replayer, least-squares calibration of the cost
               constants, and the planner-fidelity gate
    workloads  the 16 PrIM workloads as one-operator graphs

Every cost is a modelled machine's (`core.pim_model`: the Xeon, the Titan
V, the UPMEM systems), none the H100's. The executor, the runtime and the
rest of `workloads` (the LM graphs) come with ROADMAP Queue 1 items 13 and
14b.

Unit conventions across the package: every modeled cost is SECONDS
(fields/locals suffixed `_s`), every payload is BYTES (`*_bytes`), and
device names come from `placement.DEVICES` (`"xeon"`, `"titan_v"`,
`"upmem_2556"`, `"upmem_640"`).
"""

from .graph import (OpNode, OpGraph, annotate_kv_residency,
                    annotate_kv_write, chain_graph, node_from_fn,
                    ops_from_program)
from .placement import (DEVICES, Plan, compare_plans, cost_constants,
                        greedy_plan, kv_migration_time, node_bytes,
                        node_time, placed_time, plan, pure_plan,
                        transfer_hops, transfer_time)
from .schedule import LaunchGroup, Schedule, make_schedule
from .plan_cache import PlanCache, batch_signature
from . import workloads
from . import trace
