"""repro_torch.serve — the continuous-batching serving engine.

Two backends share the loop: the fused steps (`engine="jit"`, default)
and the planner-routed steps (`engine="dispatch"`,
`serve.dispatch_engine`): decode over `dispatch.workloads.decode_dag`,
prefill chunked over `dispatch.workloads.prefill_dag`, both through the
plan executor (`dispatch.executor.PlanExecutor`), which walks the
schedule's launch groups in timeline order and pipelines chunked prefill
across chunks (DESIGN.md §9-§11). Device names follow
`dispatch.placement.DEVICES`; all modeled costs are seconds, all
payloads bytes.

Above the engine sits the serving gateway (`serve.gateway`, DESIGN.md
§14): a bounded priority admission queue with reject/shed policies, a
plan cache keyed by batch signature so planner solves amortize as slot
composition churns, and SLO-aware interleaving of prefill admissions
with decode steps (`repro_torch.benchmarks.gateway_bench`)."""

from .dispatch_engine import (DispatchDecodeStep, DispatchPrefillStep,
                              dims_for_config, make_dispatch_decode_step)
from .engine import Request, ServeEngine, sample
from .gateway import (PRIORITIES, AdmissionQueue, Gateway, GatewayRequest,
                      GatewayStats, ManualClock, PricedPlan,
                      load_arrival_trace, percentile, poisson_requests,
                      save_arrival_trace)
