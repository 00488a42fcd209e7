"""Least-squares calibration of the planner's cost constants from traces.

A copy of `repro.dispatch.trace.calibrate`, kept in the port because the
port imports nothing of `repro`; it uses no framework but numpy's least
squares.

Every constant in `placement.cost_constants` is hand-anchored to the
paper's measured bands (Fig. 4 op throughputs, the host<->DPU channel
bandwidths, MRAM streaming). This module closes the loop the source
characterization warns about when moving from microbenchmarks to
end-to-end workloads: fit the same constants back out of a measured
execution trace and report per-constant drift against the anchors.

Each event class maps to one linear model in the unknown constant, so
every fit is a closed-form least squares:

  * host `compute` spans — classified memory-bound vs flop-bound at the
    anchor roofline; memory-bound spans fit `t ~ bytes / hbm_bw`,
    flop-bound spans fit `t ~ flops / peak_flops`;
  * PIM `compute` spans — one multiplicative time scale `alpha` against
    the full DPU model (`t ~ alpha * node_time`), reported both as
    `dpu.time_scale` and as the implied `dpu.mram_bw` (streaming ops are
    MRAM-bound, so throughput scales as 1/alpha). Spans whose node is
    int8-dominant (quantized expert GEMMs — the KT2-flip band) fit a
    SEPARATE scale `dpu.int8_time_scale`: the int8 band prices the DPU's
    native 8x8 multiplier, whose drift is independent of the int32
    software-ladder band's (DESIGN.md §15);
  * `stage_in` channel spans — the affine batched-transfer model
    `t ~ setup_s + bytes / host_to_dpu_bw` (two unknowns, fit jointly
    when the trace has >= 2 distinct payload sizes);
  * `exchange` channel spans — the host-relayed round trip
    `t ~ bytes / roundtrip_bw` after subtracting the per-call setups.

Feeding a trace priced exactly at the anchors (`anchor_trace`) must
recover them with ~0 drift — the round-trip property
tests/test_trace.py pins. All times are seconds, payloads bytes.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...core.pim_model import DPUModel, MACHINES, UPMEM_2556
from ..graph import OpGraph
from ..placement import (cost_constants, exchange_time, node_bytes,
                         node_time, transfer_time)
from ..schedule import TRANSFER_SETUP_S
from .events import Trace


def _lsq_through_origin(pts) -> float:
    """Closed-form least squares for `t ~ x * v` through the origin over
    `(t, v)` pairs; returns the slope x (0.0 with no usable points)."""
    num = sum(t * v for t, v in pts)
    den = sum(v * v for _, v in pts)
    return num / den if den else 0.0


def _int8_dominant(node) -> bool:
    """True when a node's MULTIPLIES are majority int8-band — the
    classifier routing a PIM compute span to the `dpu.int8_time_scale`
    fit instead of the pooled `dpu.time_scale` one. Muls are the band's
    discriminator: an int8 GEMM's int32 accumulator adds always match its
    mul count (so no GEMM is ever majority-int8 over ALL slots), but the
    muls are exactly what the 8x8-multiplier band reprices."""
    muls = {dt: cnt for (op, dt), cnt in node.ops.items() if op == "mul"}
    total = sum(muls.values())
    return total > 0 and 2 * muls.get("int8", 0) > total


def _lsq_affine(pts) -> tuple[float, float]:
    """Least squares for `t ~ a + x * v` over `(t, v)` pairs; returns
    `(a, x)` (intercept, slope) via numpy lstsq."""
    mat = np.array([[1.0, v] for _, v in pts])
    y = np.array([t for t, _ in pts])
    a, x = np.linalg.lstsq(mat, y, rcond=None)[0]
    return float(a), float(x)


@dataclasses.dataclass
class ConstantFit:
    """One calibrated cost constant: the shipped Fig.-4-anchored value vs
    the least-squares fit from a trace, with the sample count behind it.
    Units follow the constant's suffix (`*_bw` bytes/s, `*_flops`
    FLOP/s, `*_s` seconds, `*_scale` dimensionless)."""

    name: str
    anchor: float
    fitted: float
    n_events: int
    unit: str

    @property
    def drift(self) -> float:
        """Relative drift of the fit vs the anchor: fitted/anchor - 1."""
        return self.fitted / self.anchor - 1.0


@dataclasses.dataclass
class CalibrationReport:
    """Fits for every constant a trace had evidence for (constants with
    no matching events are simply absent — calibration never invents
    data)."""

    trace_name: str
    fits: list

    def fitted_constants(self) -> dict:
        """Constant name -> fitted value (keys are a subset of
        `placement.cost_constants`'s)."""
        return {f.name: f.fitted for f in self.fits}

    def render(self) -> str:
        """Human-readable drift table (one line per fitted constant)."""
        lines = [f"calibration[{self.trace_name}] "
                 f"{len(self.fits)} constant(s) fit:"]
        for f in self.fits:
            lines.append(
                f"  {f.name:24s} anchor {f.anchor:10.4g} {f.unit:6s} -> "
                f"fitted {f.fitted:10.4g}  drift {f.drift:+7.1%}  "
                f"(n={f.n_events})")
        return "\n".join(lines)


def anchor_trace(graph: OpGraph, assignment: dict,
                 dpu: DPUModel | None = None) -> Trace:
    """A synthetic measured trace priced exactly at the anchors: every
    compute span lasts `node_time`, every boundary batch lasts one setup
    plus payload over the measured channel, every exchange the
    host-relayed round trip. Feeding it to `fit_trace` must recover the
    anchors (drift ~ 0) — the estimator-correctness property the test
    suite pins; also a convenient fixture for replay/what-if demos."""
    d = dpu or UPMEM_2556
    t = Trace(name=f"{graph.name}:anchor")
    t.meta.update(modeled=True, anchor=True, graph=graph.name,
                  assignment=dict(assignment))
    preds = graph.preds
    clock = 0.0
    for n in graph.topo_order():
        dev = assignment[n]
        by_src: dict = {}
        for p in preds[n]:
            if assignment[p] != dev:
                by_src.setdefault(assignment[p], []).append(
                    graph.nodes[p].out_bytes)
        for src, payloads in sorted(by_src.items()):
            dur = TRANSFER_SETUP_S + sum(transfer_time(src, dev, b, d)
                                         for b in payloads)
            t.add("stage_in", f"{src}->{n}", "channel", clock, clock + dur,
                  bytes=float(sum(payloads)), device=dev, src=src)
            clock += dur
        dur = node_time(graph.nodes[n], dev, d)
        t.add("compute", n, dev, clock, clock + dur)
        clock += dur
    for (u, v), nb in sorted(graph.exchange_edges.items()):
        ex_t = exchange_time(assignment[u], assignment[v], nb, d)
        if ex_t:
            end = clock + ex_t + 2 * TRANSFER_SETUP_S
            t.add("exchange", f"{u}->{v}", "channel", clock, end,
                  bytes=float(nb), n_exchanges=1)
            clock = end
    return t


def fit_trace(trace: Trace, graph: OpGraph, assignment: dict,
              dpu: DPUModel | None = None) -> CalibrationReport:
    """Fit the cost-table constants from a trace's measured spans and
    report drift vs the anchors (`placement.cost_constants`).

    `graph`/`assignment` supply each compute span's regressors (flops,
    effective bytes, device); spans whose names are not graph nodes are
    ignored. Multi-step serving traces contribute every repetition as a
    sample. The channel fit assumes `stage_in` spans are host->DPU
    batches (the executor's only staging path); destination devices are
    read from the events' `device` attr."""
    d = dpu or UPMEM_2556
    anchors = cost_constants(d)
    fits: list[ConstantFit] = []

    for device in ("xeon", "titan_v"):
        m = MACHINES[device]
        mem: list = []
        flop: list = []
        for e in trace.events:
            if e.kind != "compute" or e.name not in graph.nodes:
                continue
            if assignment.get(e.name) != device or e.dur_s <= 0:
                continue
            node = graph.nodes[e.name]
            b, f = node_bytes(node, device), node.flops
            if b / m.hbm_bw >= f / m.peak_flops:
                if b > 0:
                    mem.append((e.dur_s, b))
            elif f > 0:
                flop.append((e.dur_s, f))
        x = _lsq_through_origin(mem)
        if x > 0:
            fits.append(ConstantFit(f"{device}.hbm_bw",
                                    anchors[f"{device}.hbm_bw"], 1.0 / x,
                                    len(mem), "B/s"))
        x = _lsq_through_origin(flop)
        if x > 0:
            fits.append(ConstantFit(f"{device}.peak_flops",
                                    anchors[f"{device}.peak_flops"],
                                    1.0 / x, len(flop), "FLOP/s"))

    spans = [(e.dur_s, node_time(graph.nodes[e.name], assignment[e.name], d),
              graph.nodes[e.name])
             for e in trace.events
             if e.kind == "compute" and e.name in graph.nodes
             and str(assignment.get(e.name, "")).startswith("upmem")]
    spans = [(t, mdl, n) for t, mdl, n in spans if t > 0 and mdl > 0]
    # int8-dominant spans (quantized expert GEMMs) fit their own scale:
    # the 8x8-multiplier band and the int32 software-ladder band drift
    # independently on real hardware, so one pooled alpha would let a
    # miscalibrated int8 band hide inside float-dominated traces
    pim = [(t, mdl) for t, mdl, n in spans if not _int8_dominant(n)]
    pim8 = [(t, mdl) for t, mdl, n in spans if _int8_dominant(n)]
    if pim:
        alpha = _lsq_through_origin(pim)
        if alpha > 0:
            fits.append(ConstantFit("dpu.time_scale", 1.0, alpha,
                                    len(pim), "x"))
            fits.append(ConstantFit("dpu.mram_bw", anchors["dpu.mram_bw"],
                                    anchors["dpu.mram_bw"] / alpha,
                                    len(pim), "B/s"))
    if pim8:
        alpha8 = _lsq_through_origin(pim8)
        if alpha8 > 0:
            fits.append(ConstantFit("dpu.int8_time_scale",
                                    anchors["dpu.int8_time_scale"], alpha8,
                                    len(pim8), "x"))

    chan = [(e.dur_s, float(e.attrs.get("bytes") or 0.0))
            for e in trace.events if e.kind == "stage_in"
            and str(e.attrs.get("device", "upmem")).startswith("upmem")]
    chan = [(t, b) for t, b in chan if t > 0 and b > 0]
    if chan:
        if len({b for _, b in chan}) >= 2:
            a, x = _lsq_affine(chan)
            if x > 0:
                fits.append(ConstantFit("dpu.host_to_dpu_bw",
                                        anchors["dpu.host_to_dpu_bw"],
                                        1.0 / x, len(chan), "B/s"))
                fits.append(ConstantFit("channel.setup_s",
                                        anchors["channel.setup_s"],
                                        max(a, 0.0), len(chan), "s"))
        else:                        # one payload size: pin the setup,
            setup = anchors["channel.setup_s"]        # fit bandwidth only
            x = _lsq_through_origin([(max(t - setup, 0.0), b)
                                     for t, b in chan])
            if x > 0:
                fits.append(ConstantFit("dpu.host_to_dpu_bw",
                                        anchors["dpu.host_to_dpu_bw"],
                                        1.0 / x, len(chan), "B/s"))

    ex = [(e.dur_s - 2.0 * anchors["channel.setup_s"]
           * int(e.attrs.get("n_exchanges") or 1),
           float(e.attrs.get("bytes") or 0.0))
          for e in trace.events if e.kind == "exchange"]
    ex = [(t, b) for t, b in ex if t > 0 and b > 0]
    if ex:
        x = _lsq_through_origin(ex)
        if x > 0:
            fits.append(ConstantFit("exchange.roundtrip_bw",
                                    anchors["exchange.roundtrip_bw"],
                                    1.0 / x, len(ex), "B/s"))
    return CalibrationReport(trace_name=trace.name, fits=fits)
