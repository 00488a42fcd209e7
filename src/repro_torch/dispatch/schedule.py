"""Launch/transfer scheduling: turn a placement into an execution timeline.

A copy of `repro.dispatch.schedule`, kept in the port because the port
imports nothing of `repro`; it uses no framework.

The paper's programming recommendations, made mechanical:

  * **Launch coalescing** — consecutive operators on the same device merge
    into one launch group; the fixed `launch_overhead_s` (the cost that
    makes 640->2556-DPU scaling sublinear, KT4) is paid once per group,
    not once per operator.
  * **Parallel-transfer batching** — every tensor crossing into a group is
    shipped in ONE batched parallel transfer (the paper's
    `dpu_push_xfer`-style interface): the per-call setup cost is paid once
    and the payload moves at the full parallel-transfer bandwidth, instead
    of one serial call per tensor.
  * **Compute/transfer overlap** — within a group, streaming input chunks
    double-buffer against compute, so a group costs
    `max(compute, transfer)` instead of `compute + transfer` (dependent
    groups can never prefetch each other — only intra-group streaming
    overlaps, which is why the overlapped total still sums over groups).
    GPU<->DPU tensors relay through host DRAM (Takeaway 3, both hops
    charged by `placement.transfer_time`); only the *final* hop streams
    into the group's device, so only it may hide under compute — the
    host-relay hop (`LaunchGroup.relay_s`) is serialized in front of the
    overlap window.

`make_schedule(graph, plan)` emits the timeline; `Schedule.total_s` (and
the optimistic `overlapped_s`) is the modeled wall-clock the benchmarks
report next to the plan's serial estimate. `overlapped_s` is also the
objective `placement.plan(..., objective="overlapped")` optimizes. KV
rows written off their home device (a prefill chunk's attention,
`graph.annotate_kv_write`) ship back as one batched transfer serialized
after the group — later chunks read them from the home, so the write-back
can never hide under this group's compute. Exchange edges
(`OpGraph.exchange_edges`, MoE token dispatch/combine) between
same-PIM-device endpoints are booked to the consuming member's group as
`LaunchGroup.exchange_s`: transfer-channel-only occupancy (host gather +
re-scatter) that the consumer waits on, so it is serialized into
`overlapped_s` and occupies the shared channel in the pipelined sim.

Two execution disciplines are modeled over the same group timeline:

  * **serial groups** (`total_s` / `overlapped_s`) — groups run one after
    another, each paying its own (optionally overlapped) cost; this is
    what a serial stage loop over the plan costs.
  * **pipelined groups** (`pipelined_s`, `make_schedule(...,
    pipelined=True)`) — a dependency-aware event simulation: each device
    is a serial resource, host<->device traffic occupies each rank's own
    transfer channel (`placement.channel_of`; single-rank plans book the
    one shared `"channel"`, the pre-topology degenerate case), a group
    starts when its crossing producers are done (and,
    for KV readers, when the rows they read have landed at their home —
    `meta["kv_writers"]`), and KV write-backs occupy only the channel, so
    later groups' compute runs under them. This is the discipline
    `dispatch.executor.PlanExecutor` executes, and the number
    `benchmarks.dispatch_bench` reports against the serial chunk loop.
"""

from __future__ import annotations

import dataclasses

from ..core.pim_model import DPUModel, UPMEM_2556
from .graph import OpGraph
from .placement import (Plan, _dpu_system, _is_pim, channel_of,
                        exchange_time, launch_overhead, node_time,
                        transfer_hops, transfer_time)

#: fixed cost of one host<->device transfer call (API + sync); batching N
#: buffers into one parallel transfer pays this once instead of N times
TRANSFER_SETUP_S = 2e-5


def _crossing_channels(src: str, dst: str) -> tuple[str, str]:
    """(relay-hop channel, final-hop channel) resources of one crossing.

    Rank-qualified PIM devices own their channel (`placement.channel_of`);
    rank 0, host-class devices, and the PCIe leg keep the historical
    shared `"channel"` — so every single-rank schedule books exactly the
    pre-topology resources. The relay channel only matters when
    `transfer_hops` returns a nonzero relay hop (GPU<->DPU via PCIe,
    rank->rank via host DRAM)."""
    if _is_pim(src) and _is_pim(dst):
        return channel_of(src), channel_of(dst)
    if _is_pim(src):
        # retrieve over the source rank's channel; a GPU destination adds
        # the PCIe final hop, which rides the legacy shared channel
        ch = channel_of(src)
        return (ch, "channel") if dst == "titan_v" else (ch, ch)
    if _is_pim(dst):
        ch = channel_of(dst)
        return ("channel", ch) if src == "titan_v" else (ch, ch)
    return "channel", "channel"


@dataclasses.dataclass
class LaunchGroup:
    """A maximal run of consecutive same-device operators: one launch, one
    batched input transfer. All `*_s` fields are modeled seconds; `*_bytes`
    are bytes."""
    device: str
    nodes: list[str]
    compute_s: float                  # sum of member operator times
    in_bytes: float                   # payload crossing into the group
    n_in_tensors: int                 # tensors batched into one transfer
    in_transfer_s: float              # batched: one setup + payload/bw
    serial_transfer_s: float          # unbatched: per-tensor setup (for the
                                      # "what batching buys" delta)
    launch_s: float
    relay_s: float = 0.0              # host-relay hop of GPU<->DPU inputs
    writeback_s: float = 0.0          # KV rows shipped back to their home
    n_writebacks: int = 0             # member nodes writing KV off-home
    exchange_s: float = 0.0           # host-relayed bank exchanges whose
                                      # consumer is a member (incl. setups)
    n_exchanges: int = 0              # exchange edges booked to this group
    exchange_bytes: float = 0.0       # payload of those exchange edges
    #: producer node names whose tensors cross into this group — what the
    #: executor stages ahead of the group (the batched input transfer)
    in_producers: list[str] = dataclasses.field(default_factory=list)
    #: (member node, seconds, channel resource) of each off-home KV
    #: write-back, in member order — the pipelined simulation issues them
    #: as the node finishes
    node_writebacks: list[tuple[str, float, str]] = dataclasses.field(
        default_factory=list, repr=False)
    #: per-channel occupancy breakdown of the batched input transfer
    #: (multi-rank topologies): relay-side hops (source-rank retrieves,
    #: PCIe relays) and final-side hops + setups, channel resource ->
    #: seconds. Single-rank schedules book everything on `"channel"`,
    #: and the two dicts always sum to `in_transfer_s`.
    chan_src_s: dict = dataclasses.field(default_factory=dict, repr=False)
    chan_dst_s: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def serial_s(self) -> float:
        """Group seconds with no intra-group overlap (transfer + launch +
        compute + KV write-back + bank exchanges, summed)."""
        return (self.in_transfer_s + self.launch_s + self.compute_s
                + self.writeback_s + self.exchange_s)

    @property
    def overlapped_s(self) -> float:
        """Group seconds with streaming double-buffering: input chunks
        hide under compute — but the host-relay hop of a GPU<->DPU path
        finishes before the final hop starts streaming, so it cannot hide
        under this group's compute and is serialized in front of the
        overlap window. KV write-backs are serialized after the group:
        the cache home must hold the rows before any later consumer (the
        next prefill chunk's attention) may read them. Bank exchanges
        (`exchange_s`) are transfer-channel-only occupancy that the
        consuming member waits on, so they can never hide under this
        group's own compute either."""
        return (self.relay_s
                + max(self.compute_s, self.in_transfer_s - self.relay_s)
                + self.launch_s + self.writeback_s + self.exchange_s)


@dataclasses.dataclass
class Schedule:
    """A plan's execution timeline: launch groups plus three modeled
    wall-clock totals (seconds). `overlapped_s` is the objective the
    planner's `objective="overlapped"` knob optimizes."""
    graph_name: str
    groups: list[LaunchGroup]
    out_transfer_s: float             # final retrieve to the sink
    total_s: float                    # batched, serial groups
    overlapped_s: float               # batched + intra-group overlap
    unbatched_s: float                # per-tensor transfers (the bad API)
    pipelined_s: float | None = None  # dependency-aware group pipeline
                                      # (make_schedule(..., pipelined=True))
    #: resource name -> busy seconds: per device, launch + compute it
    #: executes; "channel" aggregates every transfer-channel occupancy
    #: (batched inputs, KV write-backs, exchanges, the final retrieve)
    busy_s: dict = dataclasses.field(default_factory=dict)

    @property
    def n_launches(self) -> int:
        """Number of launch groups (= device launches paid)."""
        return len(self.groups)

    def utilization(self, wall_s: float | None = None) -> dict:
        """Resource name -> busy fraction of the wall-clock. Defaults to
        the tightest modeled wall available (`pipelined_s` when the event
        simulation ran, else `overlapped_s`); the remainder is idle —
        pipeline stalls on dependencies, the channel, or launch gaps."""
        wall = wall_s if wall_s is not None else \
            (self.pipelined_s if self.pipelined_s is not None
             else self.overlapped_s)
        if not wall:
            return {}
        return {r: b / wall for r, b in sorted(self.busy_s.items())}

    def render(self, max_groups: int = 12) -> str:
        """Multi-line human-readable timeline (ms totals, per-group rows,
        per-resource busy/idle occupancy)."""
        pipe = ("" if self.pipelined_s is None
                else f"pipelined={self.pipelined_s * 1e3:.3f}ms  ")
        lines = [f"schedule[{self.graph_name}] {self.n_launches} launch "
                 f"group(s): total={self.total_s * 1e3:.3f}ms  "
                 f"overlapped={self.overlapped_s * 1e3:.3f}ms  {pipe}"
                 f"(unbatched transfers would be "
                 f"{self.unbatched_s * 1e3:.3f}ms)"]
        util = self.utilization()
        if util:
            basis = ("pipelined" if self.pipelined_s is not None
                     else "overlapped")
            lines.append(
                f"  occupancy of {basis} wall: "
                + "  ".join(f"{r} {frac * 100.0:.1f}% busy"
                            for r, frac in util.items())
                + "  (rest idle: dependency/channel/launch stalls)")
        shown = self.groups[:max_groups]
        for g in shown:
            lines.append(
                f"  [{g.device:12s}] {len(g.nodes):3d} ops  "
                f"compute {g.compute_s * 1e3:8.3f}ms  in "
                f"{g.in_bytes / 1e6:8.2f}MB/{g.n_in_tensors} tensor(s) "
                f"{g.in_transfer_s * 1e3:7.3f}ms  "
                f"launch {g.launch_s * 1e6:6.1f}us  :: "
                + " ".join(g.nodes[:6]) + (" ..." if len(g.nodes) > 6 else ""))
        if len(self.groups) > max_groups:
            lines.append(f"  ... (+{len(self.groups) - max_groups} more "
                         "groups, same layer pattern)")
        return "\n".join(lines)

    def __str__(self) -> str:
        return self.render()


def _node_s(graph: OpGraph, n: str, dev: str, dpu: DPUModel | None,
            node_times: dict | None) -> float:
    """One member's modeled seconds, honoring a `node_times` override —
    how the trace replayer prices a timeline with measured durations."""
    if node_times is not None and n in node_times:
        return node_times[n]
    return node_time(graph.nodes[n], dev, dpu)


def make_schedule(graph: OpGraph, plan: Plan, dpu: DPUModel | None = None,
                  source: str = "xeon", sink: str = "xeon", *,
                  pipelined: bool = False,
                  order: list[str] | None = None,
                  node_times: dict | None = None,
                  events: list | None = None) -> Schedule:
    """Group a plan's topological order into launch groups and model the
    batched/overlapped timeline. `source`/`sink` must match the ones the
    plan was evaluated with for the two totals to correspond. With
    `pipelined=True` the dependency-aware event simulation also runs and
    fills `Schedule.pipelined_s` (off by default: the overlapped-objective
    coordinate descent calls this many times per plan). `order` costs an
    alternative linearization (must be a valid topological order of
    `graph`) — how `benchmarks.dispatch_bench` prices the old
    chunk-serial prefill loop against the executor's pipelined timeline.
    `node_times` overrides per-node compute seconds (name -> seconds; the
    trace replayer's measured-duration re-pricing); `events`, when a list
    and `pipelined=True`, receives the simulation's timeline as event
    dicts (`{"kind", "name", "resource", "t0", "t1", "group", "attrs"}` —
    the schema `trace.replay.modeled_trace` wraps into a `Trace`)."""
    pim_dev = next((d for d in plan.assignment.values()
                    if d.startswith("upmem")), None)
    dpu = dpu or (_dpu_system(pim_dev) if pim_dev else UPMEM_2556)
    preds = graph.preds
    if order is None:
        order = graph.topo_order()
    else:                               # an invalid linearization would
        pos = {n: i for i, n in enumerate(order)}   # silently mis-group
        if len(order) != len(graph.nodes) or set(pos) != set(graph.nodes) \
                or any(pos[p] >= pos[n] for n in order for p in preds[n]):
            raise ValueError(f"order is not a topological order of "
                             f"{graph.name}")

    groups: list[LaunchGroup] = []
    members: dict[str, int] = {}      # node -> group index
    for n in order:
        dev = plan.assignment[n]
        if not groups or groups[-1].device != dev:
            groups.append(LaunchGroup(dev, [], 0.0, 0.0, 0, 0.0, 0.0,
                                      launch_overhead(dev, dpu)))
        g = groups[-1]
        g.nodes.append(n)
        members[n] = len(groups) - 1
        g.compute_s += _node_s(graph, n, dev, dpu, node_times)

    # boundary transfers: every tensor entering a group is priced on its
    # producer's actual channel (data already resident on the group's
    # device crosses nothing); one batched transfer call per source
    # channel amortizes the setup cost. Migrated KV-cache shards are
    # boundary transfers too: a member node whose KV home is not the
    # group's device pulls its kv_bytes over the home's channel (the
    # plan's migrate_s term, kept in the timeline so Schedule and Plan
    # totals agree on KV-annotated graphs)
    for gi, g in enumerate(groups):
        crossing: list[tuple[str, float]] = []   # (src device, bytes)
        entered: set[str] = set()                # producers already shipped
        for n in g.nodes:
            for p in preds[n]:
                if members[p] != gi and plan.assignment[p] != g.device \
                        and p not in entered:
                    entered.add(p)
                    g.in_producers.append(p)
                    crossing.append((plan.assignment[p],
                                     graph.nodes[p].out_bytes))
                # a bank exchange between same-device endpoints occupies
                # only the transfer channel (host gather + re-scatter,
                # Takeaway 3); the consuming member's group books it —
                # push + pull are one parallel-transfer call each
                ex_bytes = graph.exchange_edges.get((p, n), 0.0)
                ex_t = exchange_time(plan.assignment[p], g.device,
                                     ex_bytes, dpu)
                if ex_t:
                    g.exchange_s += ex_t + 2 * TRANSFER_SETUP_S
                    g.n_exchanges += 1
                    g.exchange_bytes += ex_bytes
            meta = graph.nodes[n].meta
            kv_bytes = float(meta.get("kv_bytes") or 0.0)
            kv_home = meta.get("kv_home")
            if kv_bytes and kv_home and kv_home != g.device:
                crossing.append((kv_home, kv_bytes))
            # KV rows written off their home ship back over the measured
            # channel (the plan's write-back term, kept in the timeline so
            # Schedule and Plan totals agree on prefill DAGs); batched into
            # one transfer call per group, serialized after the group's
            # compute (later chunks read them from the home)
            wb_bytes = float(meta.get("kv_write_bytes") or 0.0)
            wb_home = meta.get("kv_write_home")
            if wb_bytes and wb_home and wb_home != g.device:
                wb_s = transfer_time(g.device, wb_home, wb_bytes, dpu)
                g.writeback_s += wb_s
                g.n_writebacks += 1
                g.node_writebacks.append(
                    (n, wb_s, _crossing_channels(g.device, wb_home)[0]))
        if g.n_writebacks:
            g.writeback_s += TRANSFER_SETUP_S
        if gi == 0 and graph.input_bytes and g.device != source:
            crossing.append((source, graph.input_bytes))
        if crossing:
            g.in_bytes = sum(b for _, b in crossing)
            g.n_in_tensors = len(crossing)
            # per-crossing hop split: the relay hop (source-rank retrieve /
            # PCIe leg) and the final hop each occupy their own channel
            # resource; the hop sum equals `transfer_time` term-for-term,
            # so single-channel payloads are bit-identical to the
            # pre-topology aggregate
            payload_s = 0.0
            for src, b in crossing:
                r_s, f_s = transfer_hops(src, g.device, b, dpu)
                r_ch, f_ch = _crossing_channels(src, g.device)
                payload_s += r_s + f_s
                g.relay_s += r_s
                if r_s:
                    g.chan_src_s[r_ch] = g.chan_src_s.get(r_ch, 0.0) + r_s
                if f_s:
                    g.chan_dst_s[f_ch] = g.chan_dst_s.get(f_ch, 0.0) + f_s
            # one batched parallel-transfer call per distinct crossing
            # source; a rank->rank crossing is two calls (retrieve on the
            # source rank's channel + push on the destination's), matching
            # the exchange model's retrieve+push setup pair
            n_setups = 0
            for src in {s for s, _ in crossing}:
                r_ch, f_ch = _crossing_channels(src, g.device)
                if _is_pim(src) and _is_pim(g.device):
                    n_setups += 2
                    g.chan_src_s[r_ch] = g.chan_src_s.get(r_ch, 0.0) \
                        + TRANSFER_SETUP_S
                else:
                    n_setups += 1
                g.chan_dst_s[f_ch] = g.chan_dst_s.get(f_ch, 0.0) \
                    + TRANSFER_SETUP_S
            n_srcs = len({s for s, _ in crossing})
            g.in_transfer_s = n_setups * TRANSFER_SETUP_S + payload_s
            g.serial_transfer_s = (len(crossing) + (n_setups - n_srcs)) \
                * TRANSFER_SETUP_S + payload_s

    succs = graph.succs
    out_transfer = 0.0
    out_channels: dict[str, float] = {}
    for leaf in (n for n in order if not succs[n]):
        t = transfer_time(plan.assignment[leaf], sink,
                          graph.nodes[leaf].out_bytes, dpu)
        if t:
            out_transfer += t + TRANSFER_SETUP_S
            ch = _crossing_channels(plan.assignment[leaf], sink)[0]
            out_channels[ch] = out_channels.get(ch, 0.0) \
                + t + TRANSFER_SETUP_S

    total = sum(g.serial_s for g in groups) + out_transfer
    overlapped = sum(g.overlapped_s for g in groups) + out_transfer
    unbatched = sum(g.serial_transfer_s + g.launch_s + g.compute_s
                    + g.writeback_s + g.exchange_s
                    + max(g.n_writebacks - 1, 0) * TRANSFER_SETUP_S
                    for g in groups) + out_transfer
    busy: dict[str, float] = {}
    for g in groups:
        busy[g.device] = busy.get(g.device, 0.0) + g.launch_s + g.compute_s
    chan_names: set[str] = set(out_channels)
    for g in groups:
        chan_names.update(g.chan_src_s, g.chan_dst_s,
                          (ch for _, _, ch in g.node_writebacks))
        if g.exchange_s:
            chan_names.add(channel_of(g.device))
    if chan_names <= {"channel"}:
        # single-channel topologies keep the historical aggregate
        # arithmetic so busy_s stays bit-identical to pre-topology runs
        chan_busy = sum(g.in_transfer_s + g.writeback_s + g.exchange_s
                        for g in groups) + out_transfer
        if chan_busy:
            busy["channel"] = chan_busy
    else:
        for g in groups:
            for ch, s in g.chan_src_s.items():
                busy[ch] = busy.get(ch, 0.0) + s
            for ch, s in g.chan_dst_s.items():
                busy[ch] = busy.get(ch, 0.0) + s
            for i, (_, wb_s, ch) in enumerate(g.node_writebacks):
                busy[ch] = busy.get(ch, 0.0) + wb_s \
                    + (TRANSFER_SETUP_S if i == 0 else 0.0)
            if g.exchange_s:
                ech = channel_of(g.device)
                busy[ech] = busy.get(ech, 0.0) + g.exchange_s
        for ch, s in out_channels.items():
            busy[ch] = busy.get(ch, 0.0) + s
    sched = Schedule(graph_name=graph.name, groups=groups,
                     out_transfer_s=out_transfer, total_s=total,
                     overlapped_s=overlapped, unbatched_s=unbatched,
                     busy_s=busy)
    if pipelined:
        sched.pipelined_s = _pipelined_total(graph, plan, groups, dpu, sink,
                                             node_times=node_times,
                                             events=events)
    return sched


def _pipelined_total(graph: OpGraph, plan: Plan, groups: list[LaunchGroup],
                     dpu: DPUModel | None, sink: str, *,
                     node_times: dict | None = None,
                     events: list | None = None) -> float:
    """Event-simulate the group timeline with pipelined resources.

    Resources: every device is a serial executor (groups on it run in
    timeline order), and every transfer-channel resource is serial too —
    single-rank plans book all host<->device traffic (batched group
    inputs, KV write-backs, the final retrieve) on ONE shared `"channel"`
    (all DPU traffic relays through the host, Takeaway 3), while rank
    r > 0 of a multi-rank topology owns its own `"channel:r"` resource
    (`placement.channel_of`), so transfers into different ranks run in
    parallel (arXiv:2105.03814). A group's batched input transfer starts
    once its crossing producers have finished and every involved channel
    is free; relay-side hops (source-rank retrieves, PCIe legs) run
    concurrently on their own channels and are serialized in front of the
    group, and the final hops still double-buffer under the group's
    compute (the same per-group algebra as `LaunchGroup.overlapped_s`,
    applied per channel). KV write-backs are issued as each writing
    member finishes and occupy only their channel — the device moves on
    to its next group, which is what lets chunk i+1's qkv ladder run
    under chunk i's write-back. A KV *reader* (a node whose
    `meta["kv_writers"]` names earlier writers) cannot start its group
    before those writers' rows have landed at the home. Returns the
    makespan in seconds; never exceeds the serial-group `overlapped_s`
    total (the serial timeline is this event system with every resource
    globally serialized). When `events` is a list, every resource
    occupancy is appended to it as an event dict (the modeled trace
    `trace.replay.modeled_trace` packages); events on each channel
    resource are mutually exclusive by construction — the per-rank
    exclusivity invariant the golden-trace test pins."""

    def emit(kind, name, resource, t0, t1, group=-1, **attrs):
        if events is not None:
            events.append({"kind": kind, "name": name, "resource": resource,
                           "t0": t0, "t1": t1, "group": group,
                           "attrs": attrs})

    done: dict[str, float] = {}
    wb_done: dict[str, float] = {}
    dev_free: dict[str, float] = {}
    chan: dict[str, float] = {}       # channel resource -> free time
    member = {n: gi for gi, g in enumerate(groups) for n in g.nodes}
    for gi, g in enumerate(groups):
        ready = 0.0
        for p in g.in_producers:
            ready = max(ready, done[p])
        for n in g.nodes:
            for w in graph.nodes[n].meta.get("kv_writers", ()):
                if member[w] == gi:    # same-group writers stay local
                    continue
                if w in wb_done:       # rows shipped back to the home
                    ready = max(ready, wb_done[w])
                elif w in done:        # writer ran AT the home: no ship
                    ready = max(ready, done[w])
                else:                  # reader scheduled before writer —
                    raise ValueError(  # a physically impossible timeline
                        f"{n} reads KV rows of {w}, which the timeline "
                        "has not executed yet")
        involved = set(g.chan_src_s) | set(g.chan_dst_s)
        if g.in_transfer_s and involved <= {"channel"}:
            # single-channel stage-in: the pre-topology aggregate algebra,
            # verbatim — one event, one channel booking, bit-identical
            # wall-clocks and event streams for every single-rank plan
            tx_start = max(chan.get("channel", 0.0), ready)
            chan["channel"] = tx_start + g.in_transfer_s
            start = max(dev_free.get(g.device, 0.0),
                        tx_start + g.relay_s)
            emit("stage_in", f"g{gi}", "channel", tx_start,
                 chan["channel"], gi, bytes=g.in_bytes,
                 n_tensors=g.n_in_tensors, device=g.device,
                 relay_s=g.relay_s, producers=list(g.in_producers))
            span = max(g.compute_s, g.in_transfer_s - g.relay_s)
        elif g.in_transfer_s:
            # multi-channel stage-in: relay-side hops run concurrently on
            # their own channels once every involved channel is free and
            # the producers are done; final hops then stream concurrently
            # into the destination, and only the destination-side span may
            # hide under the group's compute
            tx_start = max([ready] + [chan.get(ch, 0.0) for ch in involved])
            relay_end = tx_start
            for ch, s in sorted(g.chan_src_s.items()):
                chan[ch] = tx_start + s
                relay_end = max(relay_end, chan[ch])
                emit("stage_in", f"g{gi}/relay", ch, tx_start, chan[ch],
                     gi, bytes=g.in_bytes, device=g.device, side="relay")
            dst_span = 0.0
            for ch, s in sorted(g.chan_dst_s.items()):
                chan[ch] = relay_end + s
                dst_span = max(dst_span, s)
                emit("stage_in", f"g{gi}", ch, relay_end, chan[ch], gi,
                     bytes=g.in_bytes, n_tensors=g.n_in_tensors,
                     device=g.device, relay_s=relay_end - tx_start,
                     producers=list(g.in_producers))
            start = max(dev_free.get(g.device, 0.0), relay_end)
            span = max(g.compute_s, dst_span)
        else:
            start = max(dev_free.get(g.device, 0.0), ready)
            span = g.compute_s
        compute_start = start + g.launch_s
        if g.launch_s:
            emit("launch", f"g{gi}", g.device, start, compute_start, gi)
        if g.exchange_s:
            # bank exchanges occupy ONLY the consuming device's channel,
            # but the consuming member waits on them, so the group's
            # device span stretches by the exchange (plus any channel
            # contention) — other devices' compute, and other RANKS'
            # exchanges, are what run under an exchange. The exchange
            # queues after the group's own overlap window (the
            # serial-group algebra serializes it there): gating on the
            # raw channel-free time instead would re-charge the window's
            # already-counted input streaming on transfer-bound groups
            ex_ch = channel_of(g.device)
            ex_start = max(chan.get(ex_ch, 0.0), compute_start + span)
            span = (ex_start - compute_start) + g.exchange_s
            chan[ex_ch] = ex_start + g.exchange_s
            emit("exchange", f"g{gi}", ex_ch, ex_start, chan[ex_ch], gi,
                 n_exchanges=g.n_exchanges, bytes=g.exchange_bytes,
                 device=g.device)
        dev_free[g.device] = compute_start + span
        # member finish times stretch over the overlap window so the last
        # member lands exactly at the group end (the serial-group algebra)
        cum = 0.0
        prev = compute_start
        for n in g.nodes:
            cum += _node_s(graph, n, g.device, dpu, node_times)
            frac = cum / g.compute_s if g.compute_s else 1.0
            done[n] = compute_start + frac * span
            emit("compute", n, g.device, prev, done[n], gi)
            prev = done[n]
        first_wb = True
        for n, wb_s, wb_ch in g.node_writebacks:
            wb_start = max(chan.get(wb_ch, 0.0), done[n])
            chan[wb_ch] = wb_start + wb_s \
                + (TRANSFER_SETUP_S if first_wb else 0.0)
            first_wb = False
            wb_done[n] = chan[wb_ch]
            emit("writeback", n, wb_ch, wb_start, chan[wb_ch], gi,
                 seconds=wb_s)
    succs = graph.succs
    for leaf in (n for n in graph.topo_order() if not succs[n]):
        t = transfer_time(plan.assignment[leaf], sink,
                          graph.nodes[leaf].out_bytes, dpu)
        if t:
            ch = _crossing_channels(plan.assignment[leaf], sink)[0]
            out_start = max(chan.get(ch, 0.0), done[leaf])
            chan[ch] = out_start + t + TRANSFER_SETUP_S
            emit("transfer_out", leaf, ch, out_start, chan[ch],
                 sink=sink, bytes=graph.nodes[leaf].out_bytes)
    return max([0.0] + list(chan.values()) + list(dev_free.values())
               + list(wb_done.values()) + list(done.values()))
