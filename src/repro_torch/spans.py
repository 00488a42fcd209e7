"""Named spans inside the serving path, for `dispatch.trace`.

`span(name, **attrs)` marks a stretch of host code: the engine's launch,
sync and sampling, a block's attention and MLP, the MoE layer's parts.
Tracing is on while `torch.profiler` records, or while the engine whose
call is under way has a tracer attached (`ServeEngine.attach_tracer`).
Off, a span costs one check of two flags and enters nothing: no
`record_function`, whose call costs microseconds even with the profiler
off. On, it enters `torch.profiler.record_function(name)` while the
profiler records, so the span lands in the profiler's timeline beside
the device's operations, and it appends a `span` event, with the ids of
the engine call that encloses it (`step` or `rid`) and its own `attrs`,
to the trace that call records into.

`scope(trace, attached, **ids)` is entered by the engine around each
admission and step: it names that trace, those ids and whether a tracer
is attached. Outside every scope a span records no event. The state is
the process's: one serving thread at a time.

This module lives outside `repro_torch.dispatch` because the models
import it and `repro_torch.dispatch` imports the models;
`repro_torch.dispatch.trace` exports both names.
"""

from __future__ import annotations

import time

import torch
from torch.autograd import profiler as _profiler

_sink = None          # the Trace of the engine call under way, or None
_ids: dict = {}       # that call's ids: {"step": n} or {"rid": r}
_attached = False     # that call's engine has a tracer attached


class _Off:
    """The span of a stretch that nothing traces."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "rf", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        sink = _sink
        if sink is not None:
            sink.add("span", self.name, "engine", self.t0 - sink.origin,
                     t1 - sink.origin, **_ids, **self.attrs)
        return False


def span(name: str, **attrs):
    """A context manager over the stretch of code it encloses (see the
    module docstring). Names never start with `bench.`, which the
    benchmark keeps for its own phases."""
    if not (_attached or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, attrs)


class scope:
    """The engine call under way: its spans append to `trace` with `ids`;
    `attached` turns tracing on with the profiler off. Restores the
    enclosing scope on exit."""
    __slots__ = ("state", "prev")

    def __init__(self, trace, attached: bool, **ids):
        self.state = (trace, ids, attached)

    def __enter__(self):
        global _sink, _ids, _attached
        self.prev = (_sink, _ids, _attached)
        _sink, _ids, _attached = self.state
        return self

    def __exit__(self, *exc):
        global _sink, _ids, _attached
        _sink, _ids, _attached = self.prev
        return False
