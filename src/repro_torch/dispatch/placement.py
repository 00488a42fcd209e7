"""Offload placement: assign every operator to a device, minimizing modeled
end-to-end latency.

A copy of `repro.dispatch.placement`, kept in the port because the port
imports nothing of `repro`; it uses no framework, and its costs are the
modelled machines' of `core.pim_model`, none the H100's.

Devices are the paper's measured systems (`core.pim_model`): the Xeon host,
the Titan V, and one UPMEM system. Per-node costs come straight from the
calibrated models — `DPUModel.compute_time`/`mram_time`/`interdpu_time` for
PIM, the roofline `max(flops/peak, bytes/bw)` for host-class machines (the
same arithmetic as `perf_model.time_on_pim`/`time_on_host`, at operator
granularity). Crossing a device boundary charges the producer's `out_bytes`
over the measured channel: the UPMEM parallel-transfer bandwidths for
host<->DPU, PCIe for host<->GPU, and both hops for GPU<->DPU (all DPU
traffic goes through the host — Takeaway 3).

Entering a device also pays that device's launch overhead *unless the
previous operator already ran there* — so the optimizer itself discovers
the paper's launch-coalescing recommendation: consecutive PIM operators
merge into one DPU launch.

Nodes that read a resident KV-cache shard (the decode attention) carry
`meta["kv_bytes"]` / `meta["kv_home"]`: placing such a node on any device
other than the cache's home charges migrating the slot's KV over the
measured transfer channel (`kv_migration_time`) — the data-placement cost
the decode DAG planner trades against compute. Nodes that *write* KV rows
(a prefill chunk's attention) carry `meta["kv_write_bytes"]` /
`meta["kv_write_home"]` symmetrically: running them off the cache's home
charges shipping the fresh rows back. Weights/params stay device-resident
(weight-stationary serving): only activations and migrated KV cross
boundaries.

Exchange edges (`OpGraph.exchange_edges` — MoE token dispatch/combine)
charge `exchange_time`: when producer and consumer share a PIM device the
re-distribution still round-trips through host DRAM (all-to-all is the
worst case for the architecture, Takeaway 3) — the cost that lets the
planner decide host-vs-bank expert placement instead of guessing. The
charge is per-edge (no dedup) and flows through every ladder rung.

Multi-rank scale-out (`Topology`): a plan may target several RANKS of one
UPMEM base system — rank devices are ordinary placement names
(`"upmem_2556"` is rank 0, `"upmem_2556:1"` rank 1, ...), each a full DPU
array behind its own host memory channel with the base system's measured
per-rank constants (CPU<->DPU bandwidth scales near-linearly with ranks
driven in parallel, arXiv:2105.03814). Because ranks are plain device
names, every planner rung below prices expert-parallel and layer-parallel
multi-rank plans unchanged; inter-rank traffic relays through host DRAM
(`transfer_hops` — there is no direct rank-to-rank path, Takeaway 3), and
the per-rank channel concurrency is realized by the pipelined event sim
(`schedule._pipelined_total`, one transfer-channel resource per rank).

Two objectives (the `objective` knob of `plan`): `"serial"` minimizes the
additive end-to-end sum `evaluate` computes — the ladder below is exact
for it; `"overlapped"` scores candidates by the scheduler's modeled
wall-clock (`Schedule.overlapped_s`: batched transfers double-buffered
under group compute, relay hops pinned serial). For CHAIN graphs the
overlapped objective is planned *exactly* by a DP over launch-group
aggregates (`_plan_chain_overlapped_dp`, method `"dp-overlap"` — the
group boundary resets the overlap max()'s running sums, restoring the
decomposition); general DAGs fall to a deterministic local search seeded
with the serial plan (DESIGN.md §10-§11).

Planner ladder (each rung exact for its class, the next a fallback):

  1. chain DP over (position, device)         — chains (`is_chain`)
  2. frontier DP over the topological order   — exact for ANY DAG whose
     open-producer frontier stays small (series-parallel decompositions,
     out-trees, the decode DAG's residual braid); aborts past a state
     budget
  3. bounded branch-and-bound                 — general DAGs; seeded with
     the greedy incumbent and an admissible per-node lower bound, so its
     answer is never worse than greedy and exact if the budget suffices
  4. greedy topological sweep                 — the always-available floor
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

from ..core.pim_model import DPUModel, MACHINES, UPMEM_2556, UPMEM_640
from .graph import OpGraph, OpNode

#: every placeable BASE device; at most one upmem_* base system per plan,
#: but a plan may target several RANKS of it ("upmem_2556:1", ...) — see
#: `Topology` / `device_rank`
DEVICES = ("xeon", "titan_v", "upmem_2556", "upmem_640")

#: Titan V PCIe 3.0 x16 effective host<->GPU bandwidth
PCIE_BW = 12e9

#: fixed cost of starting work on a device when the previous operator ran
#: elsewhere (kernel launch / DPU program launch + host sync)
_HOST_LAUNCH_S = {"xeon": 0.0, "titan_v": 2e-5}

_DPU_SYSTEMS = {"upmem_2556": UPMEM_2556, "upmem_640": UPMEM_640}


def _is_pim(device: str) -> bool:
    return device.startswith("upmem")


def device_rank(device: str) -> tuple[str, int]:
    """Split a (possibly rank-qualified) device name into (base, rank).

    Multi-rank scale-out names ranks by suffix: `"upmem_2556"` IS rank 0
    — the exact degenerate case every pre-topology plan was priced under
    — and `"upmem_2556:1"`, `"upmem_2556:2"`, ... are further ranks of
    the same base system. Each rank is a full DPU array behind its own
    host memory channel: the extended UPMEM characterization
    (arXiv:2105.03814) measures CPU-DPU/DPU-CPU bandwidth scaling
    near-linearly with the number of ranks driven in parallel, so ranks
    do NOT share the per-rank setup/bandwidth constants."""
    base, _, r = device.partition(":")
    return (base, int(r)) if r else (base, 0)


def _dpu_system(device: str) -> DPUModel:
    """The DPU model behind a (possibly rank-qualified) PIM device name."""
    return _DPU_SYSTEMS[device_rank(device)[0]]


def channel_of(device: str) -> str:
    """The transfer-channel resource a device's host traffic occupies.

    Rank 0 and every host-class device keep the historical shared
    `"channel"` resource (so single-rank schedules, goldens, and traces
    are byte-identical to the pre-topology model); rank r > 0 owns
    `"channel:r"` — the per-rank parallelism the scale-out model prices
    and the pipelined event sim enforces exclusivity on."""
    base, r = device_rank(device)
    return "channel" if r == 0 else f"channel:{r}"


@dataclasses.dataclass(frozen=True)
class Topology:
    """A multi-rank channel topology: `n_ranks` full copies of one UPMEM
    base system, each behind its own host<->DPU transfer channel with the
    base system's measured per-rank setup/bandwidth constants
    (rank-parallel CPU<->DPU transfers, arXiv:2105.03814). Inter-rank
    exchanges have no direct path — they relay through host DRAM
    (Takeaway 3): `transfer_hops` prices a rank->rank crossing as a
    retrieve on the source rank's channel plus a push on the destination
    rank's channel.

    `Topology(n_ranks=1)` is the exact degenerate single-channel model
    every existing plan/golden was priced under. Rank devices are plain
    placement names (`rank_device`), so every planner rung prices
    multi-rank plans without topology-specific code paths."""
    base: str = "upmem_2556"
    n_ranks: int = 1

    def __post_init__(self):
        if self.base not in _DPU_SYSTEMS:
            raise ValueError(f"unknown UPMEM base {self.base!r} "
                             f"(know {sorted(_DPU_SYSTEMS)})")
        if self.n_ranks < 1:
            raise ValueError(f"need n_ranks >= 1, got {self.n_ranks}")

    def rank_device(self, r: int) -> str:
        """Placement name of rank `r` (rank 0 is the bare base name)."""
        if not 0 <= r < self.n_ranks:
            raise ValueError(f"rank {r} outside 0..{self.n_ranks - 1}")
        return self.base if r == 0 else f"{self.base}:{r}"

    @property
    def rank_devices(self) -> tuple[str, ...]:
        """Every rank's placement name, rank order."""
        return tuple(self.rank_device(r) for r in range(self.n_ranks))

    def devices(self, hosts: tuple[str, ...] = ("xeon",)) -> tuple[str, ...]:
        """The planner device set: host-class devices + every rank."""
        return tuple(hosts) + self.rank_devices

    @property
    def dpu(self) -> DPUModel:
        """The per-rank DPU system model (all ranks are identical)."""
        return _DPU_SYSTEMS[self.base]

    @property
    def signature(self) -> tuple[str, int]:
        """Hashable identity for plan caching (`plan_cache`): plans priced
        under different topologies must never alias."""
        return (self.base, self.n_ranks)


def node_bytes(node: OpNode, device: str) -> float:
    """Effective bytes an operator streams on `device` — `hbm_bytes` with
    the per-device meta overrides (`bytes_cpu`/`bytes_gpu`, e.g. TRNS
    strided writes) applied. The payload term of `node_time`'s roofline,
    and the regressor `trace.calibrate` fits host bandwidths against."""
    nbytes = node.hbm_bytes
    if device == "xeon" and node.meta.get("bytes_cpu"):
        nbytes = node.meta["bytes_cpu"]
    if device == "titan_v" and node.meta.get("bytes_gpu"):
        nbytes = node.meta["bytes_gpu"]
    return nbytes


def node_time(node: OpNode, device: str,
              dpu: DPUModel | None = None) -> float:
    """Modeled seconds for one operator on one device (no transfers)."""
    if _is_pim(device):
        d = dpu or _dpu_system(device)
        per_dpu = {k: v / d.n_dpus for k, v in node.ops.items()}
        t_c = d.compute_time(per_dpu)
        t_m = d.mram_time(node.hbm_bytes / d.n_dpus)
        # MRAM DMA overlaps compute across tasklets; inter-bank traffic
        # serializes through the host channel (Takeaway 3)
        return max(t_c, t_m) + d.interdpu_time(node.exchange_bytes)
    m = MACHINES[device]
    return max(node.flops / m.peak_flops, node_bytes(node, device) / m.hbm_bw)


def transfer_time(src: str, dst: str, nbytes: float,
                  dpu: DPUModel | None = None) -> float:
    """Seconds to move nbytes from src's memory to dst's memory."""
    if src == dst or nbytes <= 0:
        return 0.0
    d = dpu or UPMEM_2556
    t = 0.0
    if _is_pim(src):
        t += nbytes / d.dpu_to_host_bw
    if _is_pim(dst):
        t += nbytes / d.host_to_dpu_bw
    if "titan_v" in (src, dst):
        t += nbytes / PCIE_BW
    return t


def transfer_hops(src: str, dst: str, nbytes: float,
                  dpu: DPUModel | None = None) -> tuple[float, float]:
    """Split a transfer into (relay_s, final_hop_s), both seconds.

    GPU<->DPU traffic has no direct channel: it relays through host DRAM
    (Takeaway 3), and the relay hop must complete before the final hop can
    start streaming into the destination — the scheduler may only overlap
    the *final* hop with destination compute. Single-hop paths have
    relay_s == 0. The two components always sum to `transfer_time`.

    A rank->rank crossing (two PIM devices — necessarily ranks of one
    base system) also has no direct path: the retrieve into host DRAM is
    the relay hop (the source rank's channel) and the push into the
    destination rank is the final hop (the destination rank's channel) —
    the host-DRAM-relayed inter-rank exchange of the scale-out model."""
    if src == dst or nbytes <= 0:
        return 0.0, 0.0
    d = dpu or UPMEM_2556
    if _is_pim(src) and _is_pim(dst):
        return nbytes / d.dpu_to_host_bw, nbytes / d.host_to_dpu_bw
    if _is_pim(src) and dst == "titan_v":
        return nbytes / d.dpu_to_host_bw, nbytes / PCIE_BW
    if src == "titan_v" and _is_pim(dst):
        return nbytes / PCIE_BW, nbytes / d.host_to_dpu_bw
    return 0.0, transfer_time(src, dst, nbytes, dpu)


def exchange_time(src_dev: str, dst_dev: str, nbytes: float,
                  dpu: DPUModel | None = None) -> float:
    """Seconds to re-distribute `nbytes` across banks for an exchange edge
    (`OpGraph.exchange_edges`) whose producer runs on `src_dev` and
    consumer on `dst_dev`.

    Only the same-PIM-device case costs anything: there is no inter-DPU
    channel (Takeaway 3), so an all-to-all between banks round-trips
    through host DRAM — one parallel retrieve plus one parallel push over
    the measured channels. On one host-class device the shuffle is local
    (already inside the node's memory traffic); across devices the
    ordinary boundary transfer (`transfer_time`) relays through the host
    anyway, so the re-distribution rides it for free. Endpoints on two
    RANKS of one base system are distinct devices: their re-distribution
    rides the rank->rank boundary transfer (`transfer_hops` prices both
    host-DRAM-relay hops), so it is also not double-charged here."""
    if nbytes <= 0 or src_dev != dst_dev or not _is_pim(src_dev):
        return 0.0
    d = dpu or _dpu_system(src_dev)
    return nbytes / d.dpu_to_host_bw + nbytes / d.host_to_dpu_bw


def kv_migration_time(node: OpNode, device: str,
                      dpu: DPUModel | None = None) -> float:
    """Seconds of KV-residency traffic for placing `node` on `device`.

    Two terms, both zero when the node sits on the annotated home device:
    reads (`meta["kv_bytes"]`/`meta["kv_home"]`, the decode attention's
    resident cache) charge pulling the bytes *from* the home; writes
    (`meta["kv_write_bytes"]`/`meta["kv_write_home"]`, a prefill chunk's
    freshly produced KV rows) charge shipping the bytes back *to* the
    home. Both move over the measured channel (`transfer_time`)."""
    t = 0.0
    kv_bytes = float(node.meta.get("kv_bytes") or 0.0)
    home = node.meta.get("kv_home")
    if kv_bytes and home and home != device:
        t += transfer_time(home, device, kv_bytes, dpu)
    wb_bytes = float(node.meta.get("kv_write_bytes") or 0.0)
    wb_home = node.meta.get("kv_write_home")
    if wb_bytes and wb_home and wb_home != device:
        t += transfer_time(device, wb_home, wb_bytes, dpu)
    return t


def placed_time(node: OpNode, device: str,
                dpu: DPUModel | None = None) -> float:
    """node_time plus the KV-residency migration charge, in seconds — the
    per-(node, device) additive term every planner rung optimizes
    against."""
    return node_time(node, device, dpu) + kv_migration_time(node, device, dpu)


def launch_overhead(device: str, dpu: DPUModel | None = None) -> float:
    """Seconds to start work on `device` when the previous operator ran
    elsewhere (DPU program launch / kernel launch + host sync)."""
    if _is_pim(device):
        return (dpu or _dpu_system(device)).launch_overhead_s
    return _HOST_LAUNCH_S[device]


def cost_constants(dpu: DPUModel | None = None) -> dict[str, float]:
    """The calibratable cost-table anchors, name -> shipped value.

    One flat registry of every hand-anchored constant the planner's cost
    functions price with (the paper's Fig.-4/Table-style measurements),
    so `trace.calibrate.fit_trace` can report per-constant drift against
    a measured trace without reaching into three modules. Units by
    suffix: `*_bw` bytes/s, `*_flops` FLOP/s, `*_s` seconds,
    `*_scale` dimensionless (anchor 1.0)."""
    from .schedule import TRANSFER_SETUP_S  # local: schedule imports us
    d = dpu or UPMEM_2556
    return {
        "xeon.hbm_bw": MACHINES["xeon"].hbm_bw,
        "xeon.peak_flops": MACHINES["xeon"].peak_flops,
        "titan_v.hbm_bw": MACHINES["titan_v"].hbm_bw,
        "titan_v.peak_flops": MACHINES["titan_v"].peak_flops,
        "pcie.bw": PCIE_BW,
        "dpu.host_to_dpu_bw": d.host_to_dpu_bw,
        "dpu.dpu_to_host_bw": d.dpu_to_host_bw,
        "dpu.mram_bw": d.mram_bw,
        "dpu.launch_overhead_s": d.launch_overhead_s,
        "dpu.time_scale": 1.0,
        # separate multiplicative scale for int8-dominant PIM spans: the
        # int8 band prices the HW-multiplier path (pim_model.DPU_OP_COST),
        # so its drift is fit from int-band spans only (DESIGN.md §15)
        "dpu.int8_time_scale": 1.0,
        "channel.setup_s": TRANSFER_SETUP_S,
        "exchange.roundtrip_bw": 1.0 / (1.0 / d.dpu_to_host_bw
                                        + 1.0 / d.host_to_dpu_bw),
    }


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Plan:
    """A full placement and its cost breakdown.

    `assignment` maps node name -> device name (the `DEVICES` vocabulary:
    `"xeon"`, `"titan_v"`, `"upmem_2556"`, `"upmem_640"`). All `*_s`
    fields are modeled seconds under the *serial* objective (the additive
    sum `evaluate` computes); when the plan was optimized for the
    schedule-aware objective, `objective == "overlapped"` and
    `overlapped_s` holds the `Schedule.overlapped_s` score it was chosen
    by (None for serial plans)."""
    graph_name: str
    assignment: dict[str, str]         # node name -> device
    method: str                        # dp | dag-dp | bnb | greedy | pure
    total_s: float
    compute_s: float
    transfer_s: float
    launch_s: float
    node_s: dict[str, float]
    migrate_s: float = 0.0             # KV-residency migration charges
    exchange_s: float = 0.0            # host-relayed bank exchanges (MoE)
    objective: str = "serial"          # which objective picked this plan
    overlapped_s: float | None = None  # Schedule score, overlapped plans

    @property
    def n_boundary_crossings(self) -> int:
        """Number of distinct producer->consumer device crossings."""
        return len({(u, v) for u, v in self._crossings})

    _crossings: list = dataclasses.field(default_factory=list, repr=False)

    @classmethod
    def stub(cls, graph_name: str, assignment: dict,
             method: str = "stub") -> "Plan":
        """A zero-cost Plan shell around a fixed assignment — what the
        executor and the trace replayer hand to `make_schedule` when only
        the placement matters, not the planner's cost breakdown (all
        `*_s` fields 0.0)."""
        return cls(graph_name=graph_name, assignment=dict(assignment),
                   method=method, total_s=0.0, compute_s=0.0,
                   transfer_s=0.0, launch_s=0.0, node_s={})

    def device_of(self, node: str) -> str:
        """Device name the plan assigns to `node`."""
        return self.assignment[node]

    @property
    def used_devices(self) -> tuple[str, ...]:
        """Sorted device names the plan actually places operators on."""
        return tuple(sorted(set(self.assignment.values())))

    @property
    def is_hybrid(self) -> bool:
        """True when the plan spans more than one device."""
        return len(set(self.assignment.values())) > 1

    def render(self) -> str:
        """Multi-line human-readable plan listing (milliseconds per term)."""
        lines = [f"plan[{self.graph_name}] method={self.method} "
                 f"total={self.total_s * 1e3:.3f}ms  "
                 f"(compute {self.compute_s * 1e3:.3f} + transfer "
                 f"{self.transfer_s * 1e3:.3f} + launch "
                 f"{self.launch_s * 1e3:.3f} + kv-migrate "
                 f"{self.migrate_s * 1e3:.3f} + exchange "
                 f"{self.exchange_s * 1e3:.3f})"]
        for node, dev in self.assignment.items():
            lines.append(f"  {node:28s} -> {dev:12s} "
                         f"{self.node_s[node] * 1e6:10.1f}us")
        return "\n".join(lines)


def evaluate(graph: OpGraph, assignment: dict[str, str],
             dpu: DPUModel | None = None, source: str = "xeon",
             sink: str = "xeon", method: str = "fixed") -> Plan:
    """Cost a full assignment: node times + boundary transfers + launches.

    This is the single source of truth the DP optimizes against — launches
    are charged whenever the topological predecessor ran elsewhere (i.e.
    consecutive same-device operators coalesce into one launch)."""
    order = graph.topo_order()
    preds = graph.preds
    succs = graph.succs
    node_s, compute, migrate = {}, 0.0, 0.0
    for n in order:
        t = node_time(graph.nodes[n], assignment[n], dpu)
        m = kv_migration_time(graph.nodes[n], assignment[n], dpu)
        node_s[n] = t + m
        compute += t
        migrate += m

    # exchange edges: bank re-distribution relays through the host even
    # when both endpoints share a PIM device (per-edge, no dedup — every
    # exchange is its own all-to-all)
    exchange = sum(
        exchange_time(assignment[u], assignment[v], b, dpu)
        for (u, v), b in graph.exchange_edges.items())

    transfer, crossings = 0.0, []
    roots = [n for n in order if not preds[n]]
    for r in roots:
        t = transfer_time(source, assignment[r],
                          graph.input_bytes / max(len(roots), 1), dpu)
        transfer += t
        if t:
            crossings.append((source, r))
    # a producer's tensor crosses to a given device once, no matter how
    # many ops consume it there
    seen: set[tuple[str, str]] = set()
    for u, v in graph.edges:
        key = (u, assignment[v])
        if key in seen:
            continue
        seen.add(key)
        t = transfer_time(assignment[u], assignment[v],
                          graph.nodes[u].out_bytes, dpu)
        transfer += t
        if t:
            crossings.append((u, v))
    for leaf in (n for n in order if not succs[n]):
        t = transfer_time(assignment[leaf], sink,
                          graph.nodes[leaf].out_bytes, dpu)
        transfer += t
        if t:
            crossings.append((leaf, sink))

    launch, prev_dev = 0.0, None
    for n in order:
        if assignment[n] != prev_dev:
            launch += launch_overhead(assignment[n], dpu)
        prev_dev = assignment[n]

    return Plan(graph_name=graph.name, assignment=dict(assignment),
                method=method,
                total_s=compute + transfer + launch + migrate + exchange,
                compute_s=compute, transfer_s=transfer, launch_s=launch,
                node_s=node_s, migrate_s=migrate, exchange_s=exchange,
                _crossings=crossings)


def _resolve(devices: Iterable[str]) -> tuple[tuple[str, ...], DPUModel | None]:
    """Validate a planner device set: any number of host-class devices
    plus any number of RANKS of at most one UPMEM base system (ranks of
    two different bases would need two DPU models per plan)."""
    devices = tuple(devices)
    bases: set[str] = set()
    for d in devices:
        base, r = device_rank(d)
        if base not in DEVICES:
            raise ValueError(f"unknown device {d!r} (know {DEVICES})")
        if r and not _is_pim(base):
            raise ValueError(f"only UPMEM systems have ranks, got {d!r}")
        if _is_pim(base):
            bases.add(base)
    if len(bases) > 1:
        raise ValueError(f"at most one UPMEM system per plan, "
                         f"got {sorted(bases)}")
    base = next(iter(bases), None)
    return devices, (_DPU_SYSTEMS[base] if base else None)


def plan(graph: OpGraph, devices: Iterable[str] = ("xeon", "upmem_2556"),
         source: str = "xeon", sink: str = "xeon", *,
         state_budget: int = 200_000, bnb_budget: int = 200_000,
         objective: str = "serial") -> Plan:
    """Minimize modeled end-to-end latency (seconds) over per-operator
    placements.

    `objective="serial"` (default) minimizes the additive sum `evaluate`
    computes, via the fallback ladder (module docstring): chain DP when
    the graph is a chain; otherwise the exact frontier DP while its
    per-step state count stays under `state_budget`; otherwise
    branch-and-bound limited to `bnb_budget` node expansions, seeded with
    the greedy incumbent (so the result is never worse than greedy).

    `objective="overlapped"` scores candidate plans by the *scheduler's*
    modeled wall-clock instead — `Schedule.overlapped_s`, which credits
    batched parallel transfers double-buffering under each launch group's
    compute (relay hops and KV write-backs stay serialized). Chains are
    planned exactly (DP over launch-group aggregates, method
    `"dp-overlap"`); elsewhere the serial ladder's plan seeds a
    deterministic coordinate-descent search over single-node device
    moves, so the returned plan's `overlapped_s` is never worse than
    scheduling the serial-objective plan (pinned in
    tests/test_golden_plans.py)."""
    if objective not in ("serial", "overlapped"):
        raise ValueError(f"objective must be 'serial' or 'overlapped', "
                         f"got {objective!r}")
    devices, dpu = _resolve(devices)
    if objective == "overlapped" and graph.is_chain:
        # exact rung: the serial ladder's assignment would be discarded
        return _plan_chain_overlapped_dp(graph, devices, dpu, source, sink)
    if graph.is_chain:
        assignment = _plan_chain_dp(graph, devices, dpu, source, sink)
        method = "dp"
    else:
        assignment = _plan_dag_frontier_dp(graph, devices, dpu, source,
                                           sink, state_budget)
        method = "dag-dp"
        if assignment is None:
            assignment = _plan_dag_bnb(graph, devices, dpu, source, sink,
                                       bnb_budget)
            method = "bnb"
    if objective == "overlapped":
        return _refine_overlapped(graph, assignment, devices, dpu,
                                  source, sink, method)
    return evaluate(graph, assignment, dpu, source, sink, method=method)


def greedy_plan(graph: OpGraph,
                devices: Iterable[str] = ("xeon", "upmem_2556"),
                source: str = "xeon", sink: str = "xeon") -> Plan:
    """The ladder's floor, exposed for bound tests and B&B seeding."""
    devices, dpu = _resolve(devices)
    assignment = _plan_greedy(graph, devices, dpu, source)
    return evaluate(graph, assignment, dpu, source, sink, method="greedy")


def pure_plan(graph: OpGraph, device: str, source: str = "xeon",
              sink: str = "xeon") -> Plan:
    """Baseline: every operator on one device (one coalesced launch)."""
    assignment = {n: device for n in graph.nodes}
    return evaluate(graph, assignment,
                    _dpu_system(device) if _is_pim(device) else None,
                    source, sink, method="pure")


def _plan_chain_dp(graph: OpGraph, devices: tuple[str, ...],
                   dpu: DPUModel | None, source: str,
                   sink: str) -> dict[str, str]:
    order = graph.chain()
    n0 = order[0]
    cost = {d: transfer_time(source, d, graph.input_bytes, dpu)
            + launch_overhead(d, dpu)
            + placed_time(graph.nodes[n0], d, dpu) for d in devices}
    back: list[dict[str, str]] = []
    for i in range(1, len(order)):
        node, prev = graph.nodes[order[i]], graph.nodes[order[i - 1]]
        ex_b = graph.exchange_edges.get((order[i - 1], order[i]), 0.0)
        nxt, choice = {}, {}
        for d in devices:
            t_node = placed_time(node, d, dpu)
            best, best_p = float("inf"), devices[0]
            for p in devices:
                c = cost[p] + transfer_time(p, d, prev.out_bytes, dpu) \
                    + exchange_time(p, d, ex_b, dpu) \
                    + (launch_overhead(d, dpu) if d != p else 0.0) + t_node
                if c < best:
                    best, best_p = c, p
            nxt[d], choice[d] = best, best_p
        cost = nxt
        back.append(choice)
    last = graph.nodes[order[-1]]
    final = {d: cost[d] + transfer_time(d, sink, last.out_bytes, dpu)
             for d in devices}
    d = min(final, key=final.get)
    assignment = {order[-1]: d}
    for i in range(len(order) - 1, 0, -1):
        d = back[i - 1][d]
        assignment[order[i - 1]] = d
    return {n: assignment[n] for n in order}


def _plan_greedy(graph: OpGraph, devices: tuple[str, ...],
                 dpu: DPUModel | None, source: str) -> dict[str, str]:
    """Topological sweep; each operator takes the device minimizing its own
    time + incoming transfers + (launch if no predecessor is there)."""
    assignment: dict[str, str] = {}
    preds = graph.preds
    for n in graph.topo_order():
        node = graph.nodes[n]
        best, best_d = float("inf"), devices[0]
        for d in devices:
            c = placed_time(node, d, dpu)
            if preds[n]:
                for p in preds[n]:
                    c += transfer_time(assignment[p], d,
                                       graph.nodes[p].out_bytes, dpu)
                    c += exchange_time(
                        assignment[p], d,
                        graph.exchange_edges.get((p, n), 0.0), dpu)
                if all(assignment[p] != d for p in preds[n]):
                    c += launch_overhead(d, dpu)
            else:
                c += transfer_time(source, d, graph.input_bytes, dpu)
                c += launch_overhead(d, dpu)
            if c < best:
                best, best_d = c, d
        assignment[n] = best_d
    return assignment


# ---------------------------------------------------------------------------
# exact DAG planning: frontier DP + bounded branch-and-bound
# ---------------------------------------------------------------------------

class _DagWalk:
    """Incremental evaluation of `evaluate`'s objective along the fixed
    topological order. The walk state is the *frontier*: producers already
    placed whose tensors are still awaited by an unprocessed consumer, each
    carrying (device, set of devices already shipped to) — exactly the
    information `evaluate`'s transfer dedup key `(producer, dest_device)`
    needs. Summing `step` deltas over the order reproduces `evaluate`'s
    total for the same assignment."""

    def __init__(self, graph: OpGraph, dpu: DPUModel | None,
                 source: str, sink: str):
        self.graph = graph
        self.dpu = dpu
        self.source, self.sink = source, sink
        self.order = graph.topo_order()
        self.preds = graph.preds
        self.succs = graph.succs
        self.n_roots = max(sum(1 for n in self.order if not self.preds[n]), 1)
        # when the walk passes a producer's last consumer it leaves the
        # frontier (shared bookkeeping with OpGraph.max_frontier)
        self.last_use = graph.last_use_positions(self.order)

    def step(self, idx: int, d: str, prev: str | None,
             open_map: dict[str, tuple[str, frozenset]],
             ) -> tuple[float, dict[str, tuple[str, frozenset]]]:
        """Cost of placing order[idx] on `d` given the frontier, and the
        frontier after the step."""
        v = self.order[idx]
        node = self.graph.nodes[v]
        c = placed_time(node, d, self.dpu)
        if d != prev:
            c += launch_overhead(d, self.dpu)
        new_open = dict(open_map)
        if not self.preds[v]:
            c += transfer_time(self.source, d,
                               self.graph.input_bytes / self.n_roots,
                               self.dpu)
        for u in self.preds[v]:
            du, shipped = new_open[u]
            if d not in shipped:
                c += transfer_time(du, d, self.graph.nodes[u].out_bytes,
                                   self.dpu)
                new_open[u] = (du, shipped | {d})
            # exchange edges are per-edge (no dedup): every exchange is
            # its own host-relayed bank re-distribution
            c += exchange_time(du, d,
                               self.graph.exchange_edges.get((u, v), 0.0),
                               self.dpu)
        if not self.succs[v]:
            c += transfer_time(d, self.sink, node.out_bytes, self.dpu)
        for u in self.preds[v]:
            if self.last_use[u] == idx:
                del new_open[u]
        if self.succs[v]:
            # pre-seed the producer's own device: shipping to it is free,
            # so this merges cost-equivalent DP states instead of keeping
            # ({}, {d}) duplicates that double the frontier state count
            new_open[v] = (d, frozenset((d,)))
        return c, new_open


def _freeze(open_map: dict[str, tuple[str, frozenset]]) -> frozenset:
    return frozenset((n, d, s) for n, (d, s) in open_map.items())


def _plan_dag_frontier_dp(graph: OpGraph, devices: tuple[str, ...],
                          dpu: DPUModel | None, source: str, sink: str,
                          state_budget: int) -> dict[str, str] | None:
    """Exact DP over (frontier state, previous device) along the topo
    order. State count is ~ |devices|^frontier_width, so series-parallel /
    out-tree-like graphs (decode DAG: width <= 2) stay tiny; returns None
    when a step exceeds `state_budget` states (wide general DAGs)."""
    walk = _DagWalk(graph, dpu, source, sink)
    # layers[i]: state key -> (cost, previous key, device placed at step i-1)
    start_key = (None, frozenset())
    layers: list[dict[tuple, tuple[float, tuple | None, str | None]]] = [
        {start_key: (0.0, None, None)}]
    total_states = 1                   # budget caps the SUM across steps
    for idx in range(len(walk.order)):
        nxt: dict[tuple, tuple[float, tuple | None, str | None]] = {}
        for key, (cost, _, _) in layers[-1].items():
            prev, open_key = key
            open_map = {n: (d, s) for n, d, s in open_key}
            for d in devices:
                dc, new_open = walk.step(idx, d, prev, open_map)
                nk = (d, _freeze(new_open))
                c = cost + dc
                if nk not in nxt or c < nxt[nk][0]:
                    nxt[nk] = (c, key, d)
            if total_states + len(nxt) > state_budget:
                return None            # every retained layer counts: the
                                       # back-pointer tables are what the
                                       # budget is actually bounding
        total_states += len(nxt)
        layers.append(nxt)
    key = min(layers[-1], key=lambda k: layers[-1][k][0])
    assignment: dict[str, str] = {}
    for idx in range(len(walk.order), 0, -1):
        _, prev_key, d = layers[idx][key]
        assignment[walk.order[idx - 1]] = d
        key = prev_key
    return assignment


def _plan_dag_bnb(graph: OpGraph, devices: tuple[str, ...],
                  dpu: DPUModel | None, source: str, sink: str,
                  bnb_budget: int) -> dict[str, str]:
    """Depth-first branch-and-bound along the topo order.

    Incumbent = the greedy sweep (so the returned assignment never costs
    more than greedy's); lower bound = prefix cost + sum of each remaining
    node's cheapest placed_time (admissible: transfers and launches are
    non-negative). Stops refining after `bnb_budget` expansions."""
    walk = _DagWalk(graph, dpu, source, sink)
    n = len(walk.order)
    suffix_lb = [0.0] * (n + 1)
    for i in range(n - 1, -1, -1):
        node = graph.nodes[walk.order[i]]
        suffix_lb[i] = suffix_lb[i + 1] + min(
            placed_time(node, d, dpu) for d in devices)

    best = _plan_greedy(graph, devices, dpu, source)
    best_cost = evaluate(graph, best, dpu, source, sink).total_s
    expansions = 0

    # iterative DFS: (idx, prev device, frontier, prefix cost, assignment)
    stack = [(0, None, {}, 0.0, {})]
    while stack and expansions < bnb_budget:
        idx, prev, open_map, cost, assign = stack.pop()
        if idx == n:
            if cost < best_cost:
                best_cost, best = cost, assign
            continue
        children = []
        for d in devices:
            expansions += 1
            dc, new_open = walk.step(idx, d, prev, open_map)
            c = cost + dc
            if c + suffix_lb[idx + 1] >= best_cost - 1e-15:
                continue
            children.append((c, (idx + 1, d, new_open, c,
                                 {**assign, walk.order[idx]: d})))
        # cheapest child explored first (LIFO: push in reverse)
        for _, child in sorted(children, key=lambda t: t[0], reverse=True):
            stack.append(child)
    return best


# ---------------------------------------------------------------------------
# schedule-aware objective (objective="overlapped")
# ---------------------------------------------------------------------------

def _overlapped_score(graph: OpGraph, assignment: dict[str, str],
                      dpu: DPUModel | None, source: str,
                      sink: str) -> float:
    """`Schedule.overlapped_s` (seconds) of an assignment: the scheduler's
    modeled wall-clock with batched transfers double-buffered under each
    launch group's compute. The scheduler reads only the assignment, so
    the trial plan is a zero-cost stub — the coordinate descent calls
    this O(passes * nodes * devices) times and a full `evaluate` per
    trial would double its cost. Local import: schedule imports
    placement."""
    from .schedule import make_schedule
    stub = Plan(graph_name=graph.name, assignment=assignment,
                method="trial", total_s=0.0, compute_s=0.0,
                transfer_s=0.0, launch_s=0.0, node_s={})
    return make_schedule(graph, stub, dpu, source, sink).overlapped_s


def _refine_overlapped(graph: OpGraph, seed: dict[str, str],
                       devices: tuple[str, ...], dpu: DPUModel | None,
                       source: str, sink: str, method: str,
                       max_passes: int = 4) -> Plan:
    """Pick the assignment minimizing `Schedule.overlapped_s`.

    Candidates: the serial ladder's plan (`seed`), every pure placement,
    and the greedy sweep; the best then seeds a deterministic coordinate
    descent — sweep the topological order, move one node at a time to the
    device that most improves the schedule score, until a full pass makes
    no move (or `max_passes`). The seed is always in the candidate set,
    so the result is never worse (under overlapped_s) than scheduling the
    serial-objective plan. Exhaustive for one-operator graphs (the
    Hamming-1 neighborhood is the whole space); a heuristic elsewhere —
    the overlap max() couples non-adjacent operators, which breaks the DP
    decompositions the serial ladder's exactness rests on (DESIGN §10)."""
    candidates = [dict(seed), _plan_greedy(graph, devices, dpu, source)]
    candidates += [{n: d for n in graph.nodes} for d in devices]
    scored = [(_overlapped_score(graph, a, dpu, source, sink), i, a)
              for i, a in enumerate(candidates)]
    best_s, _, best = min(scored)

    order = graph.topo_order()
    for _ in range(max_passes):
        moved = False
        for n in order:
            cur = best[n]
            for d in devices:
                if d == cur:
                    continue
                trial = dict(best)
                trial[n] = d
                s = _overlapped_score(graph, trial, dpu, source, sink)
                if s < best_s - 1e-15:
                    best_s, best, moved = s, trial, True
                    cur = d
        if not moved:
            break

    p = evaluate(graph, best, dpu, source, sink,
                 method=f"{method}+overlap")
    p.objective = "overlapped"
    p.overlapped_s = best_s
    return p


def _plan_chain_overlapped_dp(graph: OpGraph, devices: tuple[str, ...],
                              dpu: DPUModel | None, source: str,
                              sink: str) -> Plan:
    """EXACT overlapped-objective planning for chain graphs: DP over
    launch-group aggregates.

    The overlap `max(compute, transfer - relay)` couples every operator
    inside a launch group, which is what breaks the serial chain DP
    (its per-position state cannot carry an unbounded group's running
    sums). But a *group boundary* resets those sums — so for a chain the
    DP can walk group extents instead of single nodes: `best[j][d]` is
    the cheapest schedule of the first `j` operators whose last group
    runs on `d`, and a transition extends a candidate group `[i, j)` on
    `d != p` one node at a time, maintaining the group's aggregates
    (compute, batched-transfer payload + per-channel setups, relay,
    KV write-backs) in O(1) — exactly the algebra `make_schedule` books
    per `LaunchGroup`, so the DP's objective IS `Schedule.overlapped_s`
    (asserted in tests against both the scheduler and brute force).
    O(n^2 * |devices|^2) over the chain length; method `"dp-overlap"`."""
    # local import: schedule imports placement (same pattern as
    # _overlapped_score)
    from .schedule import TRANSFER_SETUP_S
    order = graph.chain()
    n = len(order)
    INF = float("inf")
    # best[j]: device of the group ending at j-1 -> (cost, back-pointer);
    # the back-pointer is (group start i, previous group's device)
    best: list[dict[str | None, float]] = [{} for _ in range(n + 1)]
    back: list[dict[str | None, tuple[int, str | None]]] = \
        [{} for _ in range(n + 1)]
    best[0] = {None: 0.0}
    for i in range(n):                     # group start position
        for p, base in best[i].items():
            if i and p is None:
                continue
            for d in devices:
                if d == p:                 # maximal runs: groups alternate
                    continue
                compute = payload = relay = wb = exch = 0.0
                srcs: set[str] = set()
                n_wb = 0
                if i == 0:
                    if graph.input_bytes and d != source:
                        payload += transfer_time(source, d,
                                                 graph.input_bytes, dpu)
                        relay += transfer_hops(source, d,
                                               graph.input_bytes, dpu)[0]
                        srcs.add(source)
                else:
                    prev = graph.nodes[order[i - 1]]
                    payload += transfer_time(p, d, prev.out_bytes, dpu)
                    relay += transfer_hops(p, d, prev.out_bytes, dpu)[0]
                    srcs.add(p)
                launch = launch_overhead(d, dpu)
                for j in range(i, n):      # extend the group to order[j]
                    node = graph.nodes[order[j]]
                    compute += node_time(node, d, dpu)
                    if j > i:              # intra-group exchange edges
                        ex_t = exchange_time(
                            d, d,
                            graph.exchange_edges.get((order[j - 1],
                                                      order[j]), 0.0), dpu)
                        if ex_t:           # channel-only: push + pull call
                            exch += ex_t + 2 * TRANSFER_SETUP_S
                    kv_b = float(node.meta.get("kv_bytes") or 0.0)
                    kv_h = node.meta.get("kv_home")
                    if kv_b and kv_h and kv_h != d:
                        payload += transfer_time(kv_h, d, kv_b, dpu)
                        relay += transfer_hops(kv_h, d, kv_b, dpu)[0]
                        srcs.add(kv_h)
                    wb_b = float(node.meta.get("kv_write_bytes") or 0.0)
                    wb_h = node.meta.get("kv_write_home")
                    if wb_b and wb_h and wb_h != d:
                        wb += transfer_time(d, wb_h, wb_b, dpu)
                        n_wb += 1
                    # one transfer call per source, two for a PIM->PIM
                    # crossing (retrieve + push), as make_schedule books
                    in_transfer = sum(
                        2 if _is_pim(s) and _is_pim(d) else 1
                        for s in srcs) * TRANSFER_SETUP_S + payload
                    group_s = relay + max(compute, in_transfer - relay) \
                        + launch + wb + (TRANSFER_SETUP_S if n_wb else 0.0) \
                        + exch
                    c = base + group_s
                    if c < best[j + 1].get(d, INF):
                        best[j + 1][d] = c
                        back[j + 1][d] = (i, p)
    last = graph.nodes[order[-1]]
    final: dict[str, float] = {}
    for d, c in best[n].items():
        t = transfer_time(d, sink, last.out_bytes, dpu)
        final[d] = c + (t + TRANSFER_SETUP_S if t else 0.0)
    d = min(sorted(final), key=final.get)
    score = final[d]
    assignment: dict[str, str] = {}
    pos = n
    while pos > 0:
        i, p = back[pos][d]
        for k in range(i, pos):
            assignment[order[k]] = d
        pos, d = i, p
    p = evaluate(graph, {m: assignment[m] for m in order}, dpu, source,
                 sink, method="dp-overlap")
    p.objective = "overlapped"
    p.overlapped_s = score
    return p


def compare_plans(graph: OpGraph,
                  devices: Iterable[str] = ("xeon", "upmem_2556"),
                  pim: str = "upmem_2556") -> dict[str, Plan]:
    """The paper's Fig.-4 question asked end-to-end: pure-CPU vs pure-PIM
    vs the planner's hybrid, on one operator graph."""
    return {
        "pure_cpu": pure_plan(graph, "xeon"),
        "pure_pim": pure_plan(graph, pim),
        "hybrid": plan(graph, devices=devices),
    }
