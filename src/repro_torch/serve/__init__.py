"""repro_torch.serve — the continuous-batching serving engine.

Two backends share the loop: the fused steps (`engine="jit"`, default)
and the planner-routed steps (`engine="dispatch"`,
`serve.dispatch_engine`): decode over `dispatch.workloads.decode_dag`,
prefill chunked over `dispatch.workloads.prefill_dag`, both through the
plan executor (`dispatch.executor.PlanExecutor`), which walks the
schedule's launch groups in timeline order and pipelines chunked prefill
across chunks (DESIGN.md §9-§11). Device names follow
`dispatch.placement.DEVICES`; all modeled costs are seconds, all
payloads bytes. The serving gateway above the engine is not ported yet
(ROADMAP Queue 1, item 16)."""

from .dispatch_engine import (DispatchDecodeStep, DispatchPrefillStep,
                              dims_for_config, make_dispatch_decode_step)
from .engine import Request, ServeEngine, sample
