"""The traced slice of a `--trace 1` run: `torch.profiler` over a steady
stretch of the window whose start and length the cell's file fixes, read
into device busy time (the union of every device operation's interval),
device time by kernel name, and the idle gaps labelled by what the host
was doing (the driver's phase and the innermost host op under way).
"""

from __future__ import annotations

import collections
import contextlib

import torch

NAME_CHARS = 120           # a breakdown entry's name is cut to this


class Slice:
    """Profiles host seconds [start_s, start_s + length_s) of a window,
    started and stopped between engine calls (after their host syncs)."""

    def __init__(self, start_s: float, length_s: float, cuda: bool):
        self.start_s, self.length_s = float(start_s), float(length_s)
        self.cuda = cuda
        self.prof = None
        self.active = False
        self.done = False
        self.t_start = self.t_end = None
        self.overhead_s = 0.0      # host seconds in the profiler's start and stop

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def warm(self) -> None:
        """Start and stop the profiler once (set-up), so that the slice
        does not pay the tracer's first start."""
        with self._profile():
            torch.zeros(8, device="cuda" if self.cuda else "cpu").add_(1)
            if self.cuda:
                torch.cuda.synchronize()

    def tick(self, t: float) -> None:
        """Called between engine calls at `t` seconds into the window."""
        import time
        if not self.active and not self.done and t >= self.start_s:
            t0 = time.perf_counter()
            self.prof = self._profile()
            self.prof.start()
            self.active = True
            self.t_start = time.perf_counter()
            self.overhead_s += self.t_start - t0
        elif self.active and t >= self.start_s + self.length_s:
            self.stop()

    def stop(self) -> None:
        import time
        if self.active:
            self.t_end = time.perf_counter()
            self.prof.stop()
            self.active, self.done = False, True
            self.overhead_s += time.perf_counter() - self.t_end

    def label(self, name: str):
        if self.active:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    # ------------------------------------------------------------- #
    def read(self) -> dict | None:
        """busy_s, window_s, kernel seconds by name and the breakdown, or
        None where no slice was taken."""
        if self.prof is None or self.t_end is None:
            return None
        from torch.autograd import DeviceType
        dev, cpu = [], []
        for e in self.prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if e.is_user_annotation():
                # the driver's phases, on the host and mirrored on the
                # device's timeline: ranges, not operations
                if e.device_type() == DeviceType.CPU:
                    cpu.append((start, start + dur, e.name(),
                                e.start_thread_id()))
                continue
            if e.device_type() == DeviceType.CUDA:
                dev.append((start, start + dur, e.name()))
            elif e.device_type() == DeviceType.CPU:
                cpu.append((start, start + dur, e.name(), e.start_thread_id()))
        kernel_s = collections.Counter()
        for a, b, name in dev:
            kernel_s[name] += (b - a) * 1e-9
        busy = merge([(a, b) for a, b, _ in dev])
        phases = [c for c in cpu if c[2].startswith("bench.")]
        main = phases[0][3] if phases else None
        host = [c[:3] for c in cpu if c[3] == main]
        lo = min((c[0] for c in host), default=None)
        hi = max((c[1] for c in host), default=None)
        gaps = idle_gaps(busy, lo, hi)
        labels = label_gaps(gaps, host)
        by_label = collections.Counter()
        for (a, b), name in zip(gaps, labels):
            by_label[name] += (b - a) * 1e-9
        return {
            "window_s": self.t_end - self.t_start,
            "busy_s": sum(b - a for a, b in busy) * 1e-9,
            "kernel_s": dict(kernel_s),
            "t_start": self.t_start, "t_end": self.t_end,
            "overhead_s": self.overhead_s,
            "breakdown": {
                "device_ops": [[n[:NAME_CHARS], s]
                               for n, s in kernel_s.most_common(10)],
                "idle_gaps": [[n[:NAME_CHARS], s]
                              for n, s in by_label.most_common(10)]},
        }


def merge(intervals) -> list[tuple[int, int]]:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_gaps(busy, lo, hi) -> list[tuple[int, int]]:
    """The gaps between disjoint busy intervals, and before the first and
    after the last one within [lo, hi] where those are given."""
    gaps = []
    edge = lo
    for a, b in busy:
        if edge is not None and a > edge:
            gaps.append((edge, a))
        edge = b if edge is None else max(edge, b)
    if hi is not None and edge is not None and hi > edge:
        gaps.append((edge, hi))
    return gaps


def label_gaps(gaps, host) -> list[str]:
    """For each gap, "<driver phase>:<innermost host op>" at its midpoint
    ("-" where none): host events of one thread nest, so a stack swept
    over them in start order holds the events under way."""
    events = sorted(host, key=lambda e: (e[0], -e[1]))
    mids = sorted(range(len(gaps)), key=lambda i: gaps[i][0] + gaps[i][1])
    out = ["-:-"] * len(gaps)
    stack: list = []
    j = 0
    for i in mids:
        m = (gaps[i][0] + gaps[i][1]) // 2
        while j < len(events) and events[j][0] <= m:
            while stack and stack[-1][1] <= events[j][0]:
                stack.pop()
            stack.append(events[j])
            j += 1
        while stack and stack[-1][1] <= m:
            stack.pop()
        live = [e for e in stack if e[1] > m]
        phase = next((e[2] for e in live if e[2].startswith("bench.")), "-")
        inner = next((e[2] for e in reversed(live)
                      if not e[2].startswith("bench.")), "-")
        out[i] = f"{phase}:{inner}"
    return out
