"""The port's benchmark twins on the CPU (`repro_torch.benchmarks`):
`scaling_bench` against the reference's model numbers, `dispatch_bench
--quick` against the reference's quick sweep row for row, and
`gateway_bench --quick --trace` through the entry point with its gates.

The quick dispatch sweep plans the port's own graphs (built on the
port's census) with the port's planner: plan names, methods, and every
placement the sweep makes must be the reference's exactly; the modelled
seconds lie within tests/test_torch_workloads.py's `WALL_REL` of the
reference's, plus one unit of the last decimal the bench prints (both
tables round, so 0.049 and 0.051 print as 0.0 and 0.1). A replay error
is a difference of two modelled times, so it is held within one
hundredth of a percent.
"""

import json

import pytest

from benchmarks import dispatch_bench as j_dispatch_bench
from benchmarks.run import Report as JReport
from repro_torch.benchmarks import dispatch_bench, run, scaling_bench
from repro_torch.dispatch import workloads

#: port / reference of a modelled time (tests/test_torch_workloads.py)
WALL_REL = 0.05
#: |port - reference| of a replay error, in percent
REPLAY_ABS = 0.01


class Recorder(run.Report):
    """A report that keeps every table it is given."""

    def __init__(self):
        self.tables = []

    def table(self, rows):
        self.tables.append(rows)
        super().table(rows)


class JRecorder(JReport):
    def __init__(self):
        self.tables = []

    def table(self, rows):
        self.tables.append(rows)
        super().table(rows)


def test_scaling_bench_equals_the_reference():
    import dataclasses

    from repro import prim as j_prim
    from repro.core.perf_model import time_on_pim
    from repro.core.pim_model import UPMEM_2556
    got = scaling_bench.speedups()
    assert list(got) == list(j_prim.WORKLOADS)
    for name, mod in j_prim.WORKLOADS.items():
        c = mod.counts_l(mod.REF_N) if name == "HST-L" \
            else mod.counts(mod.REF_N)
        t = [time_on_pim(c, dataclasses.replace(UPMEM_2556, n_dpus=n))
             .total_s for n in scaling_bench.DPUS]
        assert got[name] == pytest.approx([t[0] / x for x in t], rel=1e-12)


def test_scaling_bench_entry_point(capsys):
    assert run.main(["scaling_bench", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Strong scaling" in out and "| VA |" in out
    assert "1/1 benchmark modules ok" in out


def _decimals(x) -> int:
    text = repr(float(x))
    return 0 if "e" in text or "." not in text else \
        len(text.split(".")[1].rstrip("0"))


def _same_cell(key, got, want):
    if isinstance(want, str) or isinstance(want, bool):
        assert got == want, key
    elif "replay err" in key:
        assert abs(got - want) <= REPLAY_ABS, (key, got, want)
    elif "experts on PIM" in key:
        assert got == want, key
    else:
        unit = 10.0 ** -max(_decimals(got), _decimals(want))
        assert abs(got - want) <= WALL_REL * abs(want) + unit, \
            (key, got, want)


def test_dispatch_bench_quick_rows_match_the_reference():
    got, want = Recorder(), JRecorder()
    dispatch_bench.run(got, quick=True, device="cpu")
    j_dispatch_bench.run(want, quick=True)
    assert len(got.tables) == len(want.tables) > 5
    for g_rows, w_rows in zip(got.tables, want.tables):
        assert len(g_rows) == len(w_rows)
        for g, w in zip(g_rows, w_rows):
            assert list(g) == list(w)
            for key in w:
                _same_cell(key, g[key], w[key])


def test_dispatch_bench_quick_placements_match_the_reference():
    """Every plan the quick prefill sweep makes assigns every node as the
    reference's does, on each package's own graph."""
    import contextlib
    import io
    j_dims = j_dispatch_bench.workloads.REDUCED_DIMS
    with contextlib.redirect_stdout(io.StringIO()):
        g = dispatch_bench._prefill_sweep(run.Report(),
                                          workloads.REDUCED_DIMS,
                                          prefill_len=8, chunk=4)
        w = j_dispatch_bench._prefill_sweep(JReport(), j_dims,
                                            prefill_len=8, chunk=4)
    for gp, wp in zip(g[1:3], w[1:3]):
        assert gp.assignment == wp.assignment
        assert gp.method == wp.method
    assert g[3] == pytest.approx(w[3], rel=WALL_REL)
    assert g[4] == pytest.approx(w[4], rel=WALL_REL)


def test_dispatch_bench_quick_trace_entry_point(tmp_path, capsys):
    out_json = tmp_path / "dispatch_trace.json"
    assert run.main(["dispatch_bench", "--quick", "--device", "cpu",
                     "--trace", str(out_json)]) == 0
    out = capsys.readouterr().out
    assert "objective=overlapped" in out and "tracing overhead" in out
    trace = json.loads(out_json.read_text())
    assert any(e["kind"] == "decode_step" for e in trace["events"])
    assert (tmp_path / "dispatch_trace.chrome.json").exists()


def test_gateway_bench_quick_trace_entry_point(tmp_path, capsys):
    """`gateway_bench --quick --trace`: the churn sweep's >80% hit rate,
    the overload asserts, the budget-1 gate on both engines and the
    fidelity gate on the gateway-driven dispatch trace all hold, and the
    trace and its Chrome twin are written."""
    out_json = tmp_path / "gw_trace.json"
    assert run.main(["gateway_bench", "--quick", "--device", "cpu",
                     "--trace", str(out_json)]) == 0
    out = capsys.readouterr().out
    assert "hit rate" in out and "goodput" in out
    assert "budget" in out.lower() and "PASS @ 10%" in out
    assert "1/1 benchmark modules ok" in out
    trace = json.loads(out_json.read_text())
    kinds = {e["kind"] for e in trace["events"]}
    assert {"decode_step", "prefill_step"} <= kinds
    assert (tmp_path / "gw_trace.chrome.json").exists()
