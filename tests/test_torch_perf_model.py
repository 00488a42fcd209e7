"""The port's Fig. 4 model (`repro_torch.core.perf_model` over the
`counts()` of `repro_torch.prim`) against the reference's
(`repro.core.perf_model`, `repro.prim`): every workload's counts at
several sizes, every modelled system time, and the four KT4 anchors, to
rel 1e-12 (the same arithmetic on the same constants: in practice equal).
Then the reference's paper-claims checks (tests/test_perf_model.py) on
the port's model, and the anchors `chip_smoke.py` phase 10 holds the
card's run to. Every number here is of the modelled UPMEM, Xeon and
Titan V systems, none of the H100."""

import dataclasses

import pytest

import chip_smoke
from repro import prim as jprim
from repro.core import perf_model as jpm
from repro_torch import prim
from repro_torch.core import perf_model as pm
from repro_torch.core.pim_model import UPMEM_2556, UPMEM_640

REL = 1e-12
NAMES = list(prim.WORKLOADS)


def _counts(pkg, name, n):
    mod = pkg.WORKLOADS[name]
    return mod.counts_l(n) if name == "HST-L" else mod.counts(n)


def _assert_counts_equal(got, want):
    assert got.name == want.name and got.pim_suitable == want.pim_suitable
    assert set(got.ops) == set(want.ops)
    for k, v in want.ops.items():
        assert got.ops[k] == pytest.approx(v, rel=REL)
    for f in ("bytes_streamed", "interbank_bytes", "flops_equiv",
              "bytes_cpu", "bytes_gpu"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            assert g == pytest.approx(w, rel=REL), f


@pytest.mark.parametrize("n", [1024, 1 << 16, 1 << 20, None])
@pytest.mark.parametrize("name", NAMES)
def test_counts_match_the_reference(name, n):
    n = n or jprim.WORKLOADS[name].REF_N
    _assert_counts_equal(_counts(prim, name, n), _counts(jprim, name, n))


@pytest.mark.parametrize("name", NAMES)
def test_modelled_system_times_match_the_reference(name):
    n = prim.WORKLOADS[name].REF_N
    got = pm.compare(_counts(prim, name, n))
    want = jpm.compare(_counts(jprim, name, n))
    for f in ("speedup_vs_cpu_2556", "speedup_vs_cpu_640",
              "speedup_vs_gpu_2556", "energy_eff_vs_cpu_640"):
        assert getattr(got, f) == pytest.approx(getattr(want, f), rel=REL)
    assert set(got.times) == set(want.times)
    for system, t in want.times.items():
        g = dataclasses.asdict(got.times[system])
        for f, v in dataclasses.asdict(t).items():
            if isinstance(v, str):
                assert g[f] == v
            else:
                assert g[f] == pytest.approx(v, rel=REL), (system, f)


def test_all_counts_match_the_reference():
    for n in (4096, 1 << 18):
        for got, want in zip(prim.all_counts(n), jprim.all_counts(n),
                             strict=True):
            _assert_counts_equal(got, want)
    for got, want in zip(prim.all_ref_counts(), jprim.all_ref_counts(),
                         strict=True):
        _assert_counts_equal(got, want)


@pytest.fixture(scope="module")
def figs():
    return (pm.Figure4([pm.compare(c) for c in prim.all_ref_counts()]),
            jpm.Figure4([jpm.compare(c) for c in jprim.all_ref_counts()]))


ANCHORS = ("avg_speedup_2556_vs_cpu", "avg_speedup_640_vs_cpu",
           "avg_speedup_2556_vs_gpu_suitable", "avg_energy_eff_640_vs_cpu")


@pytest.mark.parametrize("anchor", ANCHORS)
def test_fig4_anchor_matches_the_reference(figs, anchor):
    got, want = figs
    assert getattr(got, anchor) == pytest.approx(getattr(want, anchor),
                                                 rel=REL)


def test_fig4_table_matches_the_reference(figs):
    got, want = figs
    assert got.render() == want.render()
    assert pm.POWER == jpm.POWER
    assert pm.geomean([2.0, 8.0]) == jpm.geomean([2.0, 8.0]) == 4.0


def test_chip_smoke_holds_the_reference_anchors(figs):
    """chip_smoke.py cannot import the reference; its constants are the
    reference's anchors."""
    _, want = figs
    assert set(chip_smoke.FIG4_ANCHORS) == set(ANCHORS)
    for anchor in ANCHORS:
        assert chip_smoke.FIG4_ANCHORS[anchor] == pytest.approx(
            getattr(want, anchor), rel=REL)


# the reference's paper-claims checks, on the port's model

@pytest.mark.parametrize("anchor,paper,rel", [
    ("avg_speedup_2556_vs_cpu", 23.2, 0.20),
    ("avg_speedup_640_vs_cpu", 10.1, 0.20),
    ("avg_speedup_2556_vs_gpu_suitable", 2.54, 0.15),
    ("avg_energy_eff_640_vs_cpu", 1.64, 0.15)])
def test_anchor_near_the_paper(figs, anchor, paper, rel):
    assert getattr(figs[0], anchor) == pytest.approx(paper, rel=rel)


def test_suitable_group_beats_gpu_unsuitable_loses(figs):
    for c in figs[0].comparisons:
        if not c.pim_suitable:
            assert c.speedup_vs_gpu_2556 < 1.0, c.name


def test_launch_overhead_drives_sublinear_scaling():
    c = prim.va.counts(prim.va.REF_N)
    t640 = pm.time_on_pim(c, UPMEM_640).total_s
    t2556 = pm.time_on_pim(c, UPMEM_2556).total_s
    assert 1.5 < t640 / t2556 < 3.9
