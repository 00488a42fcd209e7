"""The port's chain runtime (`repro_torch.dispatch.runtime`) against the
reference's, on the reference's inputs.

`mixed_pipeline(m=256)` (int32) runs under the pure-host, pure-PIM and
the port planner's hybrid plan on 1, 2 and 4 banks: bit for bit the
reference's `runtime.reference` of the same arrays (int32 wraps alike in
both). `check_phase_discipline` counts what the reference's counts.
`decode_pipeline(REDUCED_DIMS)` (f32 GEMVs, int attention) stays within
1e-5 of the scale of the reference's result under every plan. The PIM
`trns` stages run `prim.trns.run_pim`, whose bank-local step is the
transpose kernel's plain version here; `chip_smoke.py` phase 14 runs it
on the card."""

import functools

import numpy as np
import pytest
import torch

from repro.core.bank_parallel import BankGrid as JBankGrid, make_bank_mesh
from repro.dispatch import runtime as j_runtime
from repro.dispatch import workloads as j_workloads
from repro_torch import bridge
from repro_torch.core.bank_parallel import BankGrid
from repro_torch.dispatch import runtime, workloads
from repro_torch.dispatch.placement import plan, pure_plan

BANKS = (1, 2, 4)


def _tensor(a):
    return bridge.tensor_from_numpy(np.asarray(a), "cpu")


def adopt(port, ref):
    """The port's pipeline on the reference pipeline's arrays."""
    port.x = _tensor(ref.x)
    for s, rs in zip(port.stages, ref.stages):
        assert s.name == rs.name
        s.params = tuple(_tensor(p) for p in rs.params)
    return port


@functools.cache
def mixed(m=256):
    ref = j_workloads.mixed_pipeline(m=m)
    port = adopt(workloads.mixed_pipeline(m=m, device="cpu"), ref)
    return ref, port, np.asarray(j_runtime.reference(ref))


@functools.cache
def paper_hybrid(name):
    """The planner's hybrid plan of a pipeline at its shipped size (the
    `prim-mixed` and `lm-decode-chain` graphs): streams on the banks, the
    reorganization on the host. At the tests' sizes the planner keeps
    everything on the host."""
    return plan(workloads.shipped_graphs()[name][0]())


def _plans(pipe, shipped):
    g = pipe.graph()
    return {"host": pure_plan(g, "xeon"), "pim": pure_plan(g, "upmem_2556"),
            "hybrid": paper_hybrid(shipped)}


@pytest.mark.parametrize("n_banks", BANKS)
@pytest.mark.parametrize("which", ["host", "pim", "hybrid"])
def test_mixed_pipeline_bit_exact_to_the_reference(which, n_banks):
    _, port, want = mixed()
    p = _plans(port, "prim-mixed")[which]
    rep = runtime.execute(port, p, BankGrid(n_banks, "cpu"))
    assert rep.matches and rep.max_abs_err == 0.0
    assert rep.result.dtype == torch.int32
    assert int(rep.result) == int(want)
    assert rep.stage_devices == p.assignment


def test_mixed_hybrid_plan_splits_the_chain():
    """The planner's hybrid keeps the streams bank-parallel and hands the
    reorganization to the host, as the reference's plan does."""
    from repro.dispatch.placement import plan as j_plan
    got = paper_hybrid("prim-mixed").assignment
    assert got == j_plan(j_workloads.mixed_pipeline(
        m=4096, concrete=False).graph()).assignment
    assert {got[s] for s in ("va.add", "ts.square", "red.sum")} == \
        {"upmem_2556"}
    assert {got[s] for s in ("trns.fwd", "roll.rows")} == {"xeon"}


def test_phase_discipline_counts_equal_the_reference():
    ref, port, _ = mixed()
    jgrid = JBankGrid(make_bank_mesh())
    for n in BANKS:
        assert runtime.check_phase_discipline(port, BankGrid(n, "cpu")) \
            == j_runtime.check_phase_discipline(ref, jgrid) == 4
    dref = j_workloads.decode_pipeline(j_workloads.REDUCED_DIMS)
    dport = adopt(workloads.decode_pipeline(workloads.REDUCED_DIMS,
                                            device="cpu"), dref)
    assert runtime.check_phase_discipline(dport, BankGrid(2, "cpu")) == \
        j_runtime.check_phase_discipline(dref, jgrid) == 3


def test_phase_discipline_refuses_an_exchange_in_a_local_body():
    _, port, _ = mixed()
    grid = BankGrid(2, "cpu")
    bad = runtime.Pipeline("bad", [runtime.Stage(
        "sum", lambda v: v, local_fn=lambda v: grid.exchange_gather(v))],
        port.x)
    with pytest.raises(AssertionError, match="exchange"):
        runtime.check_phase_discipline(bad, grid)


@pytest.mark.parametrize("n_banks", (1, 2))
def test_decode_pipeline_within_1e5_of_the_reference(n_banks):
    dref = j_workloads.decode_pipeline(j_workloads.REDUCED_DIMS)
    want = np.asarray(j_runtime.reference(dref))
    port = adopt(workloads.decode_pipeline(workloads.REDUCED_DIMS,
                                           device="cpu"), dref)
    scale = float(np.abs(want).max())
    for p in _plans(port, "lm-decode-chain").values():
        rep = runtime.execute(port, p, BankGrid(n_banks, "cpu"))
        np.testing.assert_allclose(rep.result.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)


def test_int_einsum_route_is_exact():
    """The card's spelling of the int32 attention products (16-bit halves
    contracted in f64, recombined mod 2^32) equals the CPU's int32 einsum
    bit for bit, wrap-around included; here the route is taken on
    tensors whose device is faked as the card."""
    g = torch.Generator().manual_seed(3)
    a = torch.randint(-2**31, 2**31 - 1, (3, 4, 50), generator=g,
                      dtype=torch.int32)
    b = torch.randint(-2**31, 2**31 - 1, (70, 4, 50), generator=g,
                      dtype=torch.int32)
    want = torch.einsum("bhd,shd->bhs", a, b)

    class Card(torch.Tensor):
        @property
        def device(self):
            return torch.device("cuda")

    got = workloads._int_einsum("bhd,shd->bhs", a.as_subclass(Card),
                                b.as_subclass(Card))
    assert torch.equal(got.as_subclass(torch.Tensor), want)


def test_graph_of_a_concrete_pipeline_equals_the_shape_only_one():
    _, port, _ = mixed()
    a = port.graph()
    b = workloads.mixed_pipeline(m=256, concrete=False).graph()
    assert list(a.nodes) == list(b.nodes) and a.edges == b.edges
    for n in a.nodes:
        assert (a.nodes[n].flops, a.nodes[n].hbm_bytes) == \
            (b.nodes[n].flops, b.nodes[n].hbm_bytes)
