"""The load driver: open and closed loops over `ServeEngine.admit` and
`ServeEngine.step`, with the host clock at every token.

Its schedule is `ServeEngine.serve`'s: admit every waiting request while
a slot is free (a one-slot prefill each), then one batched decode step.
Open loop: a request is waiting from its due time on; a stall delays
every later request, and its time counts from when it was due. Closed
loop: each client sends its next request as soon as its last one is
done. Every admission and step ends in the engine's host sync, so the
times recorded are when tokens were known on the host.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import torch

now = time.perf_counter


@dataclasses.dataclass
class Served:
    """One request as the driver saw it: the generator's `spec`, the
    engine's request, when it was due and admitted (host clock), the time
    of each token, and why it failed, if it did."""
    spec: object
    req: object
    due_at: float | None = None
    admit_at: float | None = None
    token_times: list = dataclasses.field(default_factory=list)
    failed: str | None = None

    @property
    def rid(self) -> int:
        return self.spec.rid

    @property
    def prompt(self):
        return self.spec.prompt

    @property
    def prefilled(self) -> int:
        return self.spec.prefilled

    @property
    def served(self) -> list:
        return self.req.out_tokens

    @property
    def done(self) -> bool:
        return self.req.done


class Driver:
    """Drives one engine. `prefills` holds (start, end, prompt tokens) of
    every admission and `steps` (start, end, context lengths of the live
    slots) of every decode step, on the host clock; `slice` is a
    `trace.Slice` or None."""

    def __init__(self, engine, request_cls, slice_=None):
        self.engine = engine
        self.request_cls = request_cls
        self.slice = slice_
        self.inflight: list[Served] = []
        self.served: list[Served] = []
        self.prefills: list = []
        self.steps: list = []

    # ------------------------------------------------------------- #
    def _label(self, name):
        if self.slice is None:
            return contextlib.nullcontext()
        return self.slice.label(name)

    def admit(self, spec, due_at=None) -> Served:
        req = self.request_cls(spec.rid, torch.as_tensor(spec.prompt),
                               spec.budget)
        rec = Served(spec, req, due_at=due_at)
        self.served.append(rec)
        rec.admit_at = now()
        try:
            with self._label("bench.admit"):
                ok = self.engine.admit(req)
        except (ValueError, RuntimeError) as err:
            rec.failed = f"{type(err).__name__}: {err}"
            return rec
        if not ok:
            raise RuntimeError("admit found no free slot")
        rec.token_times.append(req.first_token_at)
        self.prefills.append((rec.admit_at, req.first_token_at,
                              spec.prefilled))
        if not req.done:
            self.inflight.append(rec)
        return rec

    def step(self) -> list[Served]:
        """One decode step; returns the requests it finished."""
        lengths = [r.prefilled + len(r.served) for r in self.inflight]
        t0 = now()
        with self._label("bench.step"):
            self.engine.step()
        t1 = now()
        self.steps.append((t0, t1, lengths))
        finished = []
        for r in self.inflight:
            if len(r.served) > len(r.token_times):
                r.token_times.append(t1)
            if r.done:
                finished.append(r)
        if finished:
            self.inflight = [r for r in self.inflight if not r.done]
        return finished

    def tick(self, t0: float) -> None:
        if self.slice is not None:
            self.slice.tick(now() - t0)

    def run_until_idle(self) -> None:
        """Decode until every request in flight is done (warm-up)."""
        while self.inflight:
            self.step()

    # ------------------------------------------------------------- #
    def open_loop(self, specs, seconds: float, drain_s: float) -> dict:
        """Serve `specs` as they fall due over a window of `seconds`, then
        until each is done, for at most `drain_s` past the window: a
        request not done by then has failed."""
        pending = collections.deque(sorted(specs, key=lambda s: s.due))
        t0 = now()
        while pending or self.inflight:
            self.tick(t0)
            t = now() - t0
            if t > seconds + drain_s:
                break
            while pending and pending[0].due <= t and self.engine.n_free:
                spec = pending.popleft()
                self.admit(spec, due_at=t0 + spec.due)
                t = now() - t0
            if self.inflight:
                self.step()
            elif pending:
                with self._label("bench.wait"):
                    time.sleep(max(0.0, pending[0].due - (now() - t0)))
        for rec in self.inflight:
            rec.failed = "not done within the drain"
        for spec in pending:
            rec = Served(spec, self.request_cls(spec.rid, None, spec.budget),
                         due_at=t0 + spec.due, failed="never admitted")
            self.served.append(rec)
        return {"t0": t0, "t1": t0 + seconds, "seconds": seconds}

    def fill(self, pool) -> None:
        """Admit each client's request in progress (closed loop)."""
        for spec in pool.first():
            rec = self.admit(spec)
            self.follow(pool, rec)

    def follow(self, pool, rec) -> None:
        """Admit the next requests of `rec`'s client while the last one
        is done (a budget of one token is done at its admission)."""
        while rec.done and rec.failed is None:
            rec = self.admit(pool.next(rec.spec.client))

    def closed_loop(self, pool, seconds: float) -> dict:
        """Decode for `seconds`, each finished request followed at once by
        its client's next."""
        t0 = now()
        while now() - t0 < seconds:
            self.tick(t0)
            for rec in self.step():
                self.follow(pool, rec)
        t1 = now()
        return {"t0": t0, "t1": t1, "seconds": t1 - t0}
