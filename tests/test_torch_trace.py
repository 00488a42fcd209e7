"""The port's tracing, replay and calibration (`repro_torch.dispatch.
trace`) against the reference's (`repro.dispatch.trace`) and its pinned
contracts (tests/test_trace.py).

The two golden trace cases are built by the reference (the MoE decode DAG
on pure PIM and the dense prefill DAG on pure CPU, REDUCED), travel as JSON
into the port's `OpGraph` and are planned by both sides: the port's
`modeled_trace` equals the reference's event for event (kind, node,
resource, group and attributes exactly, times within rel 1e-9) and
`tests/golden_trace.json`'s shape. The planner-fidelity gate over every
shipped graph runs with the planner parity cases
(tests/test_torch_planner*.py), which build those graphs.
"""

import json
import pathlib

import pytest

from repro.dispatch import workloads
from repro.dispatch.placement import plan as j_plan
from repro.dispatch.placement import pure_plan as j_pure_plan
from repro.dispatch.trace import modeled_trace as j_modeled_trace
from repro_torch.dispatch.placement import (Topology, cost_constants,
                                            evaluate, plan, pure_plan)
from repro_torch.dispatch.schedule import make_schedule
from repro_torch.dispatch.trace import (EVENT_KINDS, FIDELITY_BAND,
                                        TRACE_SCHEMA_VERSION, Trace,
                                        anchor_trace, executed_order,
                                        fidelity, fit_trace,
                                        measured_node_times, modeled_trace,
                                        replay, what_if)
from test_torch_planner import graph_doc, port_graph

REL = 1e-9
EPS = 1e-9
GOLDEN = json.loads((pathlib.Path(__file__).parent
                     / "golden_trace.json").read_text())


def _reference_cases() -> dict:
    moe = workloads.moe_decode_dag(workloads.MOE_REDUCED_DIMS)
    pre = workloads.prefill_dag(workloads.REDUCED_DIMS, prefill_len=8,
                                chunk=4)
    return {"lm-moe-decode-dag-reduced:pure_pim": (moe, "upmem_2556"),
            "lm-prefill-dag-reduced:pure_cpu": (pre, "xeon")}


@pytest.fixture(scope="module")
def cases():
    """name -> (reference graph, port graph, reference trace, port plan,
    port trace)."""
    out = {}
    for name, (g, dev) in _reference_cases().items():
        tg = port_graph(graph_doc(g))
        tp = pure_plan(tg, dev)
        out[name] = (g, tg, j_modeled_trace(g, j_pure_plan(g, dev)), tp,
                     modeled_trace(tg, tp))
    return out


@pytest.mark.parametrize("name", sorted(_reference_cases()))
def test_modeled_trace_equals_the_reference(name, cases):
    _, _, want, _, got = cases[name]
    gj, wj = got.to_json(), want.to_json()
    assert gj["schema"] == wj["schema"] == TRACE_SCHEMA_VERSION
    assert len(gj["events"]) == len(wj["events"]) > 0
    for ge, we in zip(gj["events"], wj["events"]):
        for key in ("kind", "name", "resource", "group"):
            assert ge[key] == we[key], key
        for key in ("t0", "t1"):
            assert ge[key] == pytest.approx(we[key], rel=REL, abs=1e-15)
        assert set(ge["attrs"]) == set(we["attrs"])
        for k, v in we["attrs"].items():
            if isinstance(v, float):
                assert ge["attrs"][k] == pytest.approx(v, rel=REL)
            else:
                assert ge["attrs"][k] == v
    shape = [(e["kind"], e["name"], e["resource"], e["group"])
             for e in GOLDEN[name]["events"]]
    assert [(e["kind"], e["name"], e["resource"], e["group"])
            for e in gj["events"]] == shape


def test_trace_records_and_serializes(tmp_path):
    """JSON round trip preserves name, meta, and every event field; the
    loader rejects unknown schema versions."""
    t = Trace("unit", meta={"graph": "g"})
    t.add("compute", "a", "xeon", 0.0, 1.5, group=2, flops=3.0)
    t.instant("cache_hit", "mlp", "host")
    assert t.events[0].dur_s == 1.5 and t.events[1].dur_s == 0.0
    path = tmp_path / "t.json"
    t.save(path)
    back = Trace.load(path)
    assert back.name == "unit" and back.meta == {"graph": "g"}
    assert [e.to_dict() for e in back.events] == \
        [e.to_dict() for e in t.events]
    doc = t.to_json()
    doc["schema"] = 999
    with pytest.raises(ValueError, match="schema"):
        Trace.from_json(doc)


def test_chrome_export(tmp_path, cases):
    *_, t = cases["lm-moe-decode-dag-reduced:pure_pim"]
    evs = t.to_chrome()["traceEvents"]
    assert {e["args"]["name"] for e in evs if e["ph"] == "M"} == \
        set(t.resources())
    spans = [e for e in evs if e["ph"] == "X"]
    assert len(spans) == sum(1 for e in t.events if e.t1 > e.t0)
    ref = next(e for e in t.events if e.t1 > e.t0)
    chrome_ref = next(e for e in spans
                      if e["name"] == f"{ref.kind}:{ref.name}")
    assert chrome_ref["ts"] == pytest.approx(ref.t0 * 1e6)
    assert chrome_ref["dur"] == pytest.approx(ref.dur_s * 1e6)
    t.save_chrome(tmp_path / "t.chrome.json")
    assert json.loads((tmp_path / "t.chrome.json").read_text())[
        "traceEvents"]


def test_modeled_kinds_and_ordering_invariants(cases):
    """Every kind is registered, the two cases cover the modelled kinds,
    each channel and device is a serial queue, and every compute span
    starts after its producers' end."""
    seen = set()
    for name, (_, g, _, _, t) in cases.items():
        seen |= {e.kind for e in t.events}
        for res in t.resources():
            evs = sorted((e for e in t.events if e.resource == res),
                         key=lambda e: (e.t0, e.t1))
            for a, b in zip(evs, evs[1:]):
                assert b.t0 >= a.t1 - EPS, f"{name}/{res}"
        start, end = {}, {}
        for e in t.events:
            if e.kind == "compute":
                start[e.name], end[e.name] = e.t0, e.t1
        assert set(start) == set(g.nodes)
        for n in g.nodes:
            for p in g.preds.get(n, ()):
                assert end[p] <= start[n] + EPS
    assert seen <= set(EVENT_KINDS)
    assert {"compute", "launch", "stage_in", "exchange", "writeback",
            "transfer_out"} <= seen


def test_trace_helpers():
    t = Trace("synthetic")
    t.add("compute", "a", "xeon", 0.0, 1.0)
    t.add("compute", "b", "xeon", 1.0, 1.5)
    t.add("compute", "a", "xeon", 2.0, 2.25)
    assert executed_order(t) == ["a", "b", "a"]
    assert measured_node_times(t) == pytest.approx({"a": 0.25, "b": 0.5})


def test_replay_round_trip_is_exact(cases):
    for name, (_, g, _, p, t) in cases.items():
        predicted = make_schedule(g, p, pipelined=True).pipelined_s
        assert replay(t, g).total_s == pytest.approx(predicted, rel=1e-12)
    with pytest.raises(ValueError, match="assignment"):
        replay(Trace("empty"), cases["lm-moe-decode-dag-reduced:pure_pim"][1])


def test_replay_multi_step_trace_takes_last_step(cases):
    _, g, _, p, t = cases["lm-moe-decode-dag-reduced:pure_pim"]
    multi = Trace("multi", meta={"assignment": dict(p.assignment)})
    for step in range(3):
        for e in t.events:
            if e.kind == "compute":
                multi.add("compute", e.name, e.resource, step + e.t0,
                          step + e.t1)
    rep = replay(multi, g)
    assert len(rep.order) == len(g.nodes)
    assert rep.total_s == pytest.approx(replay(t, g).total_s, rel=1e-12)
    assert replay(multi, g, use_measured_times=True).total_s > 0


def test_what_if_replay(cases):
    hw = what_if(n_dpus=1234, mram_bw=1.0, launch_overhead_s=0.5)
    assert (hw.n_dpus, hw.mram_bw, hw.launch_overhead_s) == (1234, 1.0, 0.5)
    _, g, _, _, _ = cases["lm-prefill-dag-reduced:pure_cpu"]
    t = modeled_trace(g, pure_plan(g, "upmem_2556"))
    base = replay(t, g).total_s
    assert replay(t, g, dpu=what_if(channel_scale=4.0)).total_s <= base + EPS


def test_per_rank_channels_on_a_multi_rank_plan():
    """A 2-rank expert-parallel placement stages each rank's traffic on
    its own channel, each a serial queue, and replays exactly."""
    jg = workloads.moe_decode_dag(workloads.MOE_REDUCED_DIMS_INT8,
                                  expert_shards=2)
    g = port_graph(graph_doc(jg))
    topo = Topology(n_ranks=2)
    assignment = dict(pure_plan(g, "upmem_2556").assignment)
    for n in g.nodes:
        j = workloads.stage_shard(n)
        if j is not None:
            assignment[n] = topo.rank_device(j % topo.n_ranks)
    p = evaluate(g, assignment, topo.dpu, method="expert-parallel")
    t = modeled_trace(g, p)
    chans = sorted(r for r in t.resources() if r.startswith("channel"))
    assert chans == ["channel", "channel:1"]
    fid = fidelity(g, p)
    assert fid.ok and fid.band == FIDELITY_BAND
    assert fid.replayed_s == pytest.approx(fid.predicted_s, rel=1e-12)


def test_cost_constants_registry():
    cc = cost_constants()
    for k in ("xeon.hbm_bw", "xeon.peak_flops", "titan_v.hbm_bw",
              "pcie.bw", "dpu.host_to_dpu_bw", "dpu.dpu_to_host_bw",
              "dpu.mram_bw", "dpu.launch_overhead_s", "dpu.time_scale",
              "dpu.int8_time_scale", "channel.setup_s",
              "exchange.roundtrip_bw"):
        assert k in cc, k
    assert all(v > 0 for v in cc.values())
    assert cc["dpu.time_scale"] == cc["dpu.int8_time_scale"] == 1.0


def test_calibration_round_trip_recovers_anchors():
    """Fitting a synthetic trace priced exactly at the anchors recovers
    them: every `ConstantFit.drift` is ~0, as in tests/test_trace.py."""
    g = port_graph(graph_doc(workloads.decode_dag(workloads.DecodeDims())))
    p = plan(g)
    devs = set(p.assignment.values())
    assert "xeon" in devs and any(d.startswith("upmem") for d in devs)
    assert p.assignment == j_plan(workloads.decode_dag(
        workloads.DecodeDims())).assignment
    rep = fit_trace(anchor_trace(g, p.assignment), g, p.assignment)
    assert rep.fits and "dpu.time_scale" in {f.name for f in rep.fits}
    for f in rep.fits:
        assert f.n_events > 0
        assert abs(f.drift) < 1e-6, (f.name, f.fitted, f.anchor)
    assert "drift" in rep.render() and rep.fitted_constants()


@pytest.mark.parametrize("dims,fits,absent", [
    ("MOE_REDUCED_DIMS_INT8", ("dpu.int8_time_scale", "dpu.time_scale"), ()),
    ("MOE_REDUCED_DIMS", ("exchange.roundtrip_bw",),
     ("dpu.int8_time_scale",)),
])
def test_calibration_fits_int8_and_exchange_constants(dims, fits, absent):
    g = port_graph(graph_doc(workloads.moe_decode_dag(
        getattr(workloads, dims))))
    p = pure_plan(g, "upmem_2556")
    rep = fit_trace(anchor_trace(g, p.assignment), g, p.assignment)
    names = {f.name: f for f in rep.fits}
    for k in fits:
        assert abs(names[k].drift) < 1e-6, k
    for k in absent:
        assert k not in names


def test_capped_trace_keeps_the_newest_events():
    """A trace with a cap drops its oldest events first; one without keeps
    every event in a list, as before; `origin` puts event times on the
    host clock."""
    import time
    t = Trace("capped", cap=3)
    for i in range(5):
        t.add("span", f"s{i}", "engine", float(i), float(i) + 0.5)
    assert [e.name for e in t.events] == ["s2", "s3", "s4"]
    assert [e.name for e in t.by_kind("span")] == ["s2", "s3", "s4"]
    assert len(t.to_json()["events"]) == 3
    u = Trace("uncapped")
    for i in range(5):
        u.add("span", f"s{i}", "engine", float(i), float(i))
    assert isinstance(u.events, list) and len(u.events) == 5
    before = time.perf_counter()
    e = u.instant("span", "now", "engine")
    assert before <= u.origin + e.t0 <= time.perf_counter()


# --------------------------------------------------------------------- #
# spans inside the serving path
# --------------------------------------------------------------------- #

ENGINE_SITES = {"engine.decode.launch", "engine.decode.sync",
                "engine.sample", "engine.prefill.cache",
                "engine.prefill.launch", "engine.prefill.sync",
                "model.attn", "model.unembed"}
SITES = {"granite-3-8b": ENGINE_SITES | {"model.mlp"},
         "qwen2-moe-a2.7b": ENGINE_SITES | {
             "model.moe", "model.moe.router", "model.moe.aux",
             "model.moe.experts", "model.moe.combine", "model.moe.shared"}}


def _serve_a_little(arch):
    """A REDUCED engine on the CPU that admits two requests and steps
    three times; returns the engine and the process trace's events that
    it recorded."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.serve.engine import RECENT

    cfg = dataclasses.replace(get_arch(arch, reduced=True), dtype="float32")
    eng = ServeEngine(cfg, init_params(0, cfg, "cpu"), batch_slots=2,
                      max_len=32, device="cpu")
    mark = RECENT.now()
    for rid in (7, 8):
        eng.admit(Request(rid, torch.arange(5 + rid) + 1, 8))
    for _ in range(3):
        eng.step()
    return eng, [e for e in list(RECENT.events) if e.t0 >= mark]


@pytest.mark.parametrize("arch", sorted(SITES))
def test_tracing_off_records_each_step_and_no_span(arch, monkeypatch):
    """With the profiler off and no tracer attached the engine records one
    event per admission and per step, split into launch and sync within
    its duration, and no span; no site enters `record_function`."""
    import torch
    entered = []
    real = torch.profiler.record_function

    def counting(*a, **k):
        entered.append(a)
        return real(*a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    eng, events = _serve_a_little(arch)
    assert entered == []
    assert [e.kind for e in events] == ["prefill_step"] * 2 + \
        ["decode_step"] * 3
    assert [e.attrs["rid"] for e in events[:2]] == [7, 8]
    assert [e.attrs["step"] for e in events[2:]] == [1, 2, 3]
    assert all(e.attrs["n_live"] == 2 for e in events[2:])
    for e in events:
        assert e.attrs["launch_s"] > 0 and e.attrs["sync_s"] > 0
        assert e.attrs["launch_s"] + e.attrs["sync_s"] <= e.dur_s
    # the counters and the events come from the same clock reads
    assert sum(e.dur_s for e in events[2:]) == pytest.approx(eng.decode_s)
    assert sum(e.dur_s for e in events[:2]) == pytest.approx(eng.prefill_s)


@pytest.mark.parametrize("arch", sorted(SITES))
def test_spans_under_the_profiler(arch):
    """Under `torch.profiler` every site is a user annotation on the
    serving thread, each model span nested in an engine launch span, and
    each span's event in the process trace carries its step or its
    request's id."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, events = _serve_a_little(arch)
    ann = [e for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation()]
    assert {e.name() for e in ann} == SITES[arch]
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")]
    assert len({e.start_thread_id() for e in ann + ops}) == 1
    launches = [(e.start_ns(), e.start_ns() + e.duration_ns())
                for e in ann if e.name() in ("engine.decode.launch",
                                             "engine.prefill.launch")]
    for e in ann:
        if e.name().startswith("model."):
            a, b = e.start_ns(), e.start_ns() + e.duration_ns()
            assert any(lo <= a and b <= hi for lo, hi in launches), e.name()
    spans = [e for e in events if e.kind == "span"]
    assert {e.name for e in spans} == SITES[arch]
    steps = {e.t0: e for e in events if e.kind != "span"}
    for s in spans:
        ids = set(s.attrs) & {"rid", "step"}
        assert len(ids) == 1, s
        # the span lies inside the admission or step whose id it carries
        owner = next(e for e in steps.values()
                     if e.t0 <= s.t0 and s.t1 <= e.t1)
        key = ids.pop()
        assert owner.attrs[key] == s.attrs[key]
        if s.name in ("model.attn", "model.mlp", "model.moe"):
            assert s.attrs["layer"] >= 0
