"""Dispatchable workloads: the 16 PrIM workloads as one-operator graphs.

The ported part of `repro.dispatch.workloads`: `node_from_counts` and
`prim_graph`, on `core.perf_model.WorkloadCounts`. The mixed PrIM
pipelines, the LM decode chain and DAGs, the chunked prefill DAGs, the
MoE and sliding-window graphs and `shipped_graphs()` come with ROADMAP
Queue 1 item 13.
"""

from __future__ import annotations

from ..core.perf_model import WorkloadCounts
from .graph import OpGraph, OpNode, chain_graph


def node_from_counts(c: WorkloadCounts) -> OpNode:
    """Lift a PrIM workload's analytic counts into a single OpNode (the
    whole workload is one operator — Fig. 4's granularity)."""
    return OpNode(name=c.name, kind="prim", flops=c.flops_equiv,
                  hbm_bytes=c.bytes_streamed, out_bytes=0.0,
                  ops=dict(c.ops), exchange_bytes=c.interbank_bytes,
                  meta={"pim_suitable": c.pim_suitable,
                        "bytes_cpu": c.bytes_cpu, "bytes_gpu": c.bytes_gpu})


def prim_graph(c: WorkloadCounts) -> OpGraph:
    """A PrIM workload as a one-node OpGraph (the planner's unit case)."""
    return chain_graph(c.name, [node_from_counts(c)])
