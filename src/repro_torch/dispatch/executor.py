"""Unified plan executor: run the planner's Schedule, not a serial loop.

The port of `repro.dispatch.executor`. The planner chooses a `Plan`, the
scheduler turns it into a `Schedule` timeline of launch groups, and
`PlanExecutor` is the ONE execution loop for any plan over any operator
DAG: it walks the schedule's launch groups in timeline order.

Three pieces:

  * `StageDef` — one stage *kind* (e.g. `"qkv"`): the host body plus the
    per-argument/per-output bank-shard axes that define its PIM face
    (`None` replicates — weights, the KV prefix; an integer shards that
    axis over banks — decode shards batch slots on axis 0, prefill shards
    a chunk's token rows on axis 1).
  * `FaceCache` — the faces per kind, shared across executors. A host
    face calls the body. A PIM face is a `BankGrid` local phase over the
    grid's banks, each sharded argument split along its bank axis; it
    runs batched (`BankGrid.local(..., batched=True)`): the stage bodies
    are row-wise (a row's projection, its attention over its own cache
    rows, its token's expert dispatch), so one call over the stacked
    banks computes every bank's shard with the kernels' launch at the
    whole batch, and the same bits at any bank count. Nothing is
    compiled: a face is *built* on its first call for a shape signature
    (the counterpart of a jit specialization), which `stats` counts as a
    compile.
  * `PlanExecutor` — binds a graph + assignment to the `Schedule` group
    timeline and runs it: for each group, consume staged inputs, dispatch
    every member stage on the group's device, then *stage the next
    group's boundary tensors* (`LaunchGroup.in_producers`) into one of
    two staging slots. Host and PIM faces both run on the grid's device
    (the card), so staging moves no bytes between devices; the executor
    keeps the reference's order and its accounting (`tracer` spans with
    the bytes a UPMEM system would move).

The caller supplies a `bind(name, env)` callback mapping a node name and
the environment of prior results to the stage's argument tuple — the
whole workload-specific surface, which is why `serve.dispatch_engine`'s
decode and prefill steps are thin adapters over this module (DESIGN.md
§11). Executing the timeline is a reordering of independent stages, so
results equal any serial execution of the same faces.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Sequence

import torch
from torch.utils._pytree import tree_leaves

from ..core.bank_parallel import BANKS, BankGrid
from .graph import OpGraph
from .placement import Plan
from .schedule import Schedule, make_schedule
from .workloads import stage_kind


@dataclasses.dataclass(frozen=True)
class StageDef:
    """One executable stage kind: host body + PIM-face shard axes.

    `arg_banks` / `out_banks` give, per argument / per output, the axis
    that shards over the BankGrid's banks (`None` replicates). The PIM
    face is usable for a call only when every sharded argument's axis
    length divides the bank count — otherwise the executor falls back to
    the host face (ragged prefill tails) and counts the fallback."""
    kind: str
    fn: Callable
    arg_banks: tuple[int | None, ...]
    out_banks: tuple[int | None, ...]

    @property
    def n_out(self) -> int:
        """Number of outputs the stage body returns."""
        return len(self.out_banks)


def _signature(args: tuple) -> tuple:
    """The shapes and dtypes of a call's tensor arguments (weights, passed
    in dicts, are fixed for a kind): one face build each."""
    return tuple((a.shape, a.dtype) for a in args
                 if isinstance(a, torch.Tensor))


def _bank_phase(grid: BankGrid, s: StageDef) -> Callable:
    """The stage's bank-parallel face: every sharded argument's bank axis
    moved to the front (a view) and split over the banks, the body run
    once over the stacked banks, each output's banks merged back along
    its axis."""
    n = grid.n_banks

    def to_front(t, ax):
        return t if not ax else t.movedim(ax, 0)

    def from_front(t, ax):
        return t if not ax else t.movedim(0, ax)

    def body(*shards):
        args = [a if ax is None else from_front(a.flatten(0, 1), ax)
                for a, ax in zip(shards, s.arg_banks)]
        outs = s.fn(*args)
        outs = outs if s.n_out > 1 else (outs,)
        return tuple(o if ax is None else to_front(o, ax).unflatten(
            0, (n, -1)) for o, ax in zip(outs, s.out_banks))

    phase = grid.local(body, in_specs=tuple(
        None if ax is None else BANKS for ax in s.arg_banks),
        out_specs=tuple(None if ax is None else BANKS
                        for ax in s.out_banks), batched=True)

    def face(*args):
        outs = phase(*[a if ax is None else to_front(a, ax)
                       for a, ax in zip(args, s.arg_banks)])
        outs = tuple(o if ax is None else from_front(o, ax)
                     for o, ax in zip(outs, s.out_banks))
        return outs if s.n_out > 1 else outs[0]
    return face


class FaceCache:
    """Per-kind stage faces, shared across `PlanExecutor`s.

    Host faces call the body; PIM faces are BankGrid local phases built
    from the `StageDef`'s shard axes. The cache accounts for itself:
    every face call and every build (the first call of a (face, kind) at
    a new shape signature) is counted per (face, kind) and exposed through
    `stats`, with the host-face fallbacks of PIM-placed calls whose bank
    axis does not divide over the banks; with a `tracer` attached
    (`trace.Trace`, set by `PlanExecutor.run(..., tracer=...)`) each call
    also records a `compile` span or `cache_hit` instant event."""

    def __init__(self, stages: Sequence[StageDef], grid: BankGrid):
        self.grid = grid
        kinds = [s.kind for s in stages]
        dup = sorted({k for k in kinds if kinds.count(k) > 1})
        if dup:                                   # e.g. MoE + dense "mlp"
            raise ValueError(f"duplicate StageDef kinds {dup}: two stage "
                             "bodies would silently share one face")
        self.stages = {s.kind: s for s in stages}
        self.tracer = None                       # trace.Trace | None
        self._calls: dict[tuple[str, str], int] = {}
        self._compiles: dict[tuple[str, str], int] = {}
        self._built: set[tuple] = set()
        #: kind -> PIM-placed calls that ran on the host face instead
        self.fallbacks: dict[str, int] = {}
        self._host = {k: self._face("host", k, s.fn)
                      for k, s in self.stages.items()}
        self._pim: dict[str, Callable] = {}      # lazy

    def _face(self, face, kind, fn):
        """Wrap a face with call/build accounting and (when a tracer is
        attached) compile-vs-cache-hit events."""
        key = (face, kind)

        def call(*args):
            self._calls[key] = self._calls.get(key, 0) + 1
            sig = (face, kind, _signature(args))
            built = sig not in self._built
            if built:
                self._built.add(sig)
                self._compiles[key] = self._compiles.get(key, 0) + 1
            tr = self.tracer
            if tr is None:
                return fn(*args)
            t0 = tr.now()
            out = fn(*args)
            if built:
                tr.add("compile", kind, face, t0)
            else:
                tr.instant("cache_hit", kind, face)
            return out
        return call

    @property
    def stats(self) -> dict:
        """Cache accounting: `{"calls", "compiles", "hits"}` totals plus
        per-face (`"host"`/`"pim"`) and per-kind (`"by_kind"`)
        breakdowns, and `"fallbacks"` (kind -> PIM-placed calls run on
        the host face). A *hit* is a call served by an already-built
        face; `compiles` counts builds, one per new shape signature."""
        out = {"calls": 0, "compiles": 0, "hits": 0,
               "host": {"calls": 0, "compiles": 0},
               "pim": {"calls": 0, "compiles": 0},
               "by_kind": {}, "fallbacks": dict(self.fallbacks)}
        for (face, kind), n in self._calls.items():
            out["calls"] += n
            out[face]["calls"] += n
            k = out["by_kind"].setdefault(kind, {"calls": 0, "compiles": 0})
            k["calls"] += n
        for (face, kind), n in self._compiles.items():
            out["compiles"] += n
            out[face]["compiles"] += n
            k = out["by_kind"].setdefault(kind, {"calls": 0, "compiles": 0})
            k["compiles"] += n
        out["hits"] = out["calls"] - out["compiles"]
        return out

    def host(self, kind: str) -> Callable:
        """The host face for a stage kind."""
        return self._host[kind]

    def pim(self, kind: str) -> Callable:
        """The bank-parallel face for a stage kind (built lazily)."""
        if kind not in self._pim:
            self._pim[kind] = self._face(
                "pim", kind, _bank_phase(self.grid, self.stages[kind]))
        return self._pim[kind]

    def pim_ok(self, kind: str, args: tuple) -> bool:
        """True when every bank-sharded argument axis divides the bank
        count — the predicate for routing a call to the PIM face."""
        n = self.grid.n_banks
        return all(axis is None or arg.shape[axis] % n == 0
                   for arg, axis in zip(args, self.stages[kind].arg_banks))


def _nbytes(v) -> float:
    return float(sum(t.numel() * t.element_size() for t in tree_leaves(v)
                     if isinstance(t, torch.Tensor)))


class PlanExecutor:
    """Execute a placement over an operator DAG in Schedule timeline order.

    Built once per (graph, assignment): the timeline is `make_schedule`'s
    launch-group sequence for the (possibly force-overridden) assignment,
    so the executed group order is exactly the order the golden schedules
    pin. `run(bind)` walks it; `bind` supplies each node's argument tuple
    from the environment of already-computed results."""

    def __init__(self, graph: OpGraph, assignment: dict[str, str],
                 faces: FaceCache, *, kind_of: Callable[[str], str]
                 = stage_kind, source: str = "xeon", sink: str = "xeon"):
        self.graph = graph
        self.assignment = dict(assignment)
        self.faces = faces
        self.kind_of = kind_of
        missing = [n for n in graph.nodes
                   if kind_of(n) not in faces.stages]
        if missing:
            raise ValueError(f"no StageDef for nodes {sorted(missing)[:6]}; "
                             "stage kinds drifted from the DAG's node names")
        stub = Plan.stub(graph.name, self.assignment, method="executor")
        self.schedule: Schedule = make_schedule(graph, stub, source=source,
                                                sink=sink)
        self.timeline = [(g.device, tuple(g.nodes), tuple(g.in_producers))
                         for g in self.schedule.groups]
        # last group that reads each node's output (its own group for
        # leaves): run() frees dead entries past this point
        member = {n: k for k, (_, nodes, _) in enumerate(self.timeline)
                  for n in nodes}
        self._dead_after: list[list[str]] = [[] for _ in self.timeline]
        for n, succs in graph.succs.items():
            last = max((member[s] for s in succs), default=member[n])
            self._dead_after[last].append(n)
        # exchange edges between same-PIM-device endpoints execute as an
        # explicit host gather/scatter before the consumer's face runs —
        # the executable twin of the host-relayed all-to-all the
        # scheduler books as `LaunchGroup.exchange_s`
        self._exchange_in: dict[str, list[str]] = {}
        for (u, v), nbytes in graph.exchange_edges.items():
            if nbytes > 0 and self.assignment[u] == self.assignment[v] \
                    and self.assignment[u].startswith("upmem"):
                self._exchange_in.setdefault(v, []).append(u)

    def executed_order(self) -> list[tuple[str, list[str]]]:
        """The (device, member nodes) launch groups in execution order —
        the contract the golden schedules pin against executor drift."""
        return [(dev, list(nodes)) for dev, nodes, _ in self.timeline]

    def devices_used(self) -> dict[str, str]:
        """Node name -> device name the executor routes it through."""
        return dict(self.assignment)

    def _dispatch(self, name: str, device: str, args: tuple) -> Any:
        kind = self.kind_of(name)
        if device.startswith("upmem"):
            if self.faces.pim_ok(kind, args):
                return self.faces.pim(kind)(*args)
            fb = self.faces.fallbacks
            fb[kind] = fb.get(kind, 0) + 1
        return self.faces.host(kind)(*args)

    @staticmethod
    def _stage_in(producers: tuple[str, ...], env: dict,
                  slot: dict) -> None:
        """Stage the next group's boundary tensors into a staging slot (the
        batched host->bank push of a UPMEM system). On one card the banks'
        memory is the card's, so the slot holds the producers' tensors
        themselves; clearing it first drops the previous round's
        references — the double-buffer donation."""
        slot.clear()
        for p in producers:
            if p in env:
                slot[p] = env[p]

    def run(self, bind: Callable[[str, dict], tuple],
            env: dict | None = None,
            keep: Iterable[str] = (), *,
            tracer=None, block: bool = False) -> dict:
        """Execute every launch group in timeline order; returns the
        environment mapping node name -> stage output(s). `bind(name,
        env)` must return the argument tuple for `name`'s stage kind.
        Entries are freed once their last GRAPH-EDGE consumer's group has
        dispatched — so `bind` may only read a node's edge-declared
        predecessors from `env`; any off-graph read and every output the
        caller reads after the run must be pinned by name in `keep`.

        `tracer` (a `trace.Trace`) records the measured timeline: a
        `compute` span per dispatched node, a `stage_in` span (resource
        `"channel"`) per boundary staging, an `exchange` span per host
        relay, plus the FaceCache's compile/cache-hit events; the
        untraced path is untouched. `block` additionally synchronizes the
        card after every stage so compute spans measure execution rather
        than the launch."""
        env = dict(env or {})
        keep = set(keep)
        staging: list[dict] = [{}, {}]           # double-buffered slots
        prev_tracer = self.faces.tracer
        if tracer is not None:
            self.faces.tracer = tracer
        sync = (torch.cuda.synchronize if block and
                self.faces.grid.device.type == "cuda" else (lambda: None))
        try:
            for k, (device, nodes, _) in enumerate(self.timeline):
                for p, v in staging[k % 2].items():
                    env[p] = v                   # consume staged inputs
                for name in nodes:
                    relays = self._exchange_in.get(name, ())
                    if relays and tracer is not None:
                        # the exchange's host relay (gather back +
                        # re-scatter): on one card the tensors stay put
                        t0 = tracer.now()
                        nb = sum(_nbytes(env[p]) for p in relays if p in env)
                        tracer.add("exchange", name, "channel", t0, group=k,
                                   bytes=float(nb), n_exchanges=len(relays))
                    if tracer is None:
                        env[name] = self._dispatch(name, device,
                                                   bind(name, env))
                    else:
                        t0 = tracer.now()
                        out = self._dispatch(name, device, bind(name, env))
                        sync()
                        tracer.add("compute", name, device, t0, group=k,
                                   stage=self.kind_of(name))
                        env[name] = out
                if k + 1 < len(self.timeline):
                    nxt_dev, _, nxt_producers = self.timeline[k + 1]
                    slot = staging[(k + 1) % 2]
                    if nxt_dev.startswith("upmem"):
                        if tracer is None:
                            self._stage_in(nxt_producers, env, slot)
                        else:
                            t0 = tracer.now()
                            self._stage_in(nxt_producers, env, slot)
                            nb = sum(_nbytes(v) for v in slot.values())
                            tracer.add("stage_in", f"g{k + 1}", "channel",
                                       t0, group=k + 1, bytes=float(nb),
                                       device=nxt_dev,
                                       producers=sorted(slot))
                    else:
                        slot.clear()
                for name in self._dead_after[k]:
                    if name not in keep:
                        env.pop(name, None)
        finally:
            self.faces.tracer = prev_tracer
        return env
