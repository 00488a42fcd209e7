"""Structured execution traces: the event stream everything else reads.

A copy of `repro.dispatch.trace.events`, kept in the port because the port
imports nothing of `repro`; it uses no framework.

A `Trace` is an append-only list of `TraceEvent` spans over named
*resources* — device names from `placement.DEVICES` plus the two
pseudo-resources `"channel"` (the ONE shared host<->device transfer
channel of the pipelined discipline, DESIGN.md §13) and `"engine"` (the
serving loop). The executor (`dispatch.executor.PlanExecutor.run(...,
tracer=...)`) records *measured* spans with `time.perf_counter`; the
scheduler's pipelined event simulation (`trace.replay.modeled_trace`)
records *modeled* spans in cost-model seconds. Both produce the same
schema, which is what lets `trace.calibrate` fit cost constants from
measured traces and `trace.replay` re-price recorded timelines.

All timestamps and durations are SECONDS relative to the trace origin;
payload attributes are BYTES. Traces serialize to a versioned JSON
document (`Trace.save` / `Trace.load`) and to Chrome's `trace_event`
format (`Trace.save_chrome`) loadable in chrome://tracing or Perfetto.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Any

#: bump when the serialized event schema changes shape (golden traces and
#: archived benchmark artifacts pin the version they were written with)
TRACE_SCHEMA_VERSION = 1

#: every event kind the tracer emits; `compute`/`launch` occupy a device,
#: `stage_in`/`exchange`/`writeback`/`transfer_out` occupy the shared
#: transfer channel, `compile`/`cache_hit` are FaceCache accounting,
#: `prefill_step`/`decode_step` are the serving engine's admissions and
#: batched steps (scalar attributes: the host seconds spent issuing the
#: work, `launch_s`, and waiting on the device, `sync_s`, and the ids
#: `rid` or `step`), and `span` is a named stretch of host code inside
#: one of them (`repro_torch.spans.span`), with that call's id
EVENT_KINDS = ("compute", "launch", "stage_in", "exchange", "writeback",
               "transfer_out", "compile", "cache_hit", "prefill_step",
               "decode_step", "span")


@dataclasses.dataclass
class TraceEvent:
    """One timestamped span: `kind` (see `EVENT_KINDS`) of `name` on
    `resource`, from `t0` to `t1` (seconds since trace origin; `t0 == t1`
    for instant events). `group` is the launch-group index the span
    belongs to (-1 when not group-scoped); `attrs` carries kind-specific
    payload (bytes, producer names, stage kind, ...)."""

    kind: str
    name: str
    resource: str
    t0: float
    t1: float
    group: int = -1
    attrs: dict = dataclasses.field(default_factory=dict)

    @property
    def dur_s(self) -> float:
        """Span duration in seconds (0.0 for instant events)."""
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        """Plain-JSON form (the schema `Trace.save` writes)."""
        return {"kind": self.kind, "name": self.name,
                "resource": self.resource, "t0": self.t0, "t1": self.t1,
                "group": self.group, "attrs": self.attrs}

    @classmethod
    def from_dict(cls, d: dict) -> "TraceEvent":
        """Inverse of `to_dict` (used by `Trace.load`)."""
        return cls(kind=d["kind"], name=d["name"], resource=d["resource"],
                   t0=d["t0"], t1=d["t1"], group=d.get("group", -1),
                   attrs=dict(d.get("attrs") or {}))


class Trace:
    """An execution trace: event recorder + serializer.

    Recording is append-only and cheap (one `perf_counter` call and one
    list append per event) so a tracer can stay attached to the serving
    hot loop — the <5% overhead budget benchmarks.dispatch_bench
    measures. `meta` carries run-level context (graph name, assignment,
    whether spans are modeled or measured). With a `cap`, the trace holds
    the last `cap` events, the oldest dropped first; without one it holds
    every event. `origin` is the `time.perf_counter()` value at t = 0, so
    `origin + e.t0` is on the host clock."""

    def __init__(self, name: str = "trace", meta: dict | None = None,
                 cap: int | None = None):
        self.name = name
        self.meta: dict = dict(meta or {})
        self.events: list[TraceEvent] | collections.deque = (
            [] if cap is None else collections.deque(maxlen=cap))
        self.origin = time.perf_counter()

    def now(self) -> float:
        """Seconds since the trace origin (monotonic, `perf_counter`)."""
        return time.perf_counter() - self.origin

    def add(self, kind: str, name: str, resource: str, t0: float,
            t1: float | None = None, group: int = -1,
            **attrs: Any) -> TraceEvent:
        """Record a span; `t1=None` closes it at the current clock (the
        measured-span idiom: grab `t0 = tracer.now()`, do the work, then
        `tracer.add(...)`). Returns the recorded event."""
        ev = TraceEvent(kind, name, resource, t0,
                        self.now() if t1 is None else t1, group, attrs)
        self.events.append(ev)
        return ev

    def instant(self, kind: str, name: str, resource: str, group: int = -1,
                **attrs: Any) -> TraceEvent:
        """Record a zero-duration event at the current clock."""
        t = self.now()
        return self.add(kind, name, resource, t, t, group, **attrs)

    def by_kind(self, kind: str) -> list[TraceEvent]:
        """Every recorded event of one kind, in recorded order."""
        return [e for e in self.events if e.kind == kind]

    def resources(self) -> list[str]:
        """Sorted resource names the trace touches."""
        return sorted({e.resource for e in self.events})

    def to_json(self) -> dict:
        """The versioned JSON document (`{"schema", "name", "meta",
        "events"}`) golden traces and `--trace` outputs are written as."""
        return {"schema": TRACE_SCHEMA_VERSION, "name": self.name,
                "meta": self.meta,
                "events": [e.to_dict() for e in self.events]}

    @classmethod
    def from_json(cls, doc: dict) -> "Trace":
        """Rebuild a trace from `to_json`'s document (schema-checked)."""
        if doc.get("schema") != TRACE_SCHEMA_VERSION:
            raise ValueError(f"trace schema {doc.get('schema')!r} != "
                             f"supported {TRACE_SCHEMA_VERSION}")
        t = cls(name=doc.get("name", "trace"), meta=doc.get("meta"))
        t.events = [TraceEvent.from_dict(d) for d in doc["events"]]
        return t

    def save(self, path) -> None:
        """Write the versioned JSON document to `path`."""
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")

    @classmethod
    def load(cls, path) -> "Trace":
        """Read a trace written by `save`."""
        with open(path) as f:
            return cls.from_json(json.load(f))

    def to_chrome(self) -> dict:
        """Chrome `trace_event` form: one pseudo-thread per resource
        (named via `thread_name` metadata events), spans as complete
        (`ph="X"`) events, instants as `ph="i"`; timestamps in
        microseconds as the format requires."""
        tids = {r: i + 1 for i, r in enumerate(self.resources())}
        out: list[dict] = [
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": tid,
             "args": {"name": r}} for r, tid in tids.items()]
        for e in self.events:
            rec: dict = {"name": f"{e.kind}:{e.name}", "cat": e.kind,
                         "pid": 1, "tid": tids[e.resource],
                         "ts": e.t0 * 1e6,
                         "args": {"group": e.group, **e.attrs}}
            if e.t1 > e.t0:
                rec.update(ph="X", dur=(e.t1 - e.t0) * 1e6)
            else:
                rec.update(ph="i", s="t")
            out.append(rec)
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": {"trace": self.name, **{
                    k: v for k, v in self.meta.items()
                    if isinstance(v, (str, int, float, bool))}}}

    def save_chrome(self, path) -> None:
        """Write the Chrome `trace_event` JSON to `path` (open it in
        chrome://tracing or https://ui.perfetto.dev)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")
