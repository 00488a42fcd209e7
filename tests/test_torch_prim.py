"""The port's PrIM suite (`repro_torch.prim`) on the CPU against the
reference (`repro.prim`). Inputs are drawn once through the reference's
`make_inputs` (`jax.random`) and handed to both packages as numpy; the
port's bank-local phases reach the plain PyTorch versions of its kernels
(`kernels.ops` on CPU tensors). The CUDA kernels run only on the card
(chip_smoke.py phase 9).

Tolerances: every result is compared as the same bits (the reference's
uint32 results, GEMV's and the histograms', against the port's int32),
except SpMV: its 16 products per row may be summed in another order than XLA's, so it is held
within 1e-5 of each row's sum of |products| (one row at n = 1024 cancels
to 0.0237 from a magnitude of 15.8; the two orders differ there by 6e-7).

The reference's own `run_pim` is not the oracle where it is at fault: SEL
and UNI crash in it (ROADMAP F3), and its TS scores windows that run past
the end of the series (F5); the port is held to `ref` there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import prim as jprim
from repro.prim import ts as jts
from repro_torch import prim
from repro_torch.core.bank_parallel import BankGrid, census
from repro_torch.kernels import gemv as kgemv
from repro_torch.kernels import ops, ref
from repro_torch.kernels import reduction as kred
from repro_torch.kernels import scan_block as kscan

KEY = jax.random.PRNGKey(3)
SIZES = {"NW": 64, "MLP": 128, "BFS": 128, "GEMV": 256}   # test_prim.py's
NAMES = sorted(prim.WORKLOADS)
SPMV_RTOL = 1e-5


def _n(name):
    return SIZES.get(name, 1024)


@functools.cache
def _jax_case(name):
    """(reference inputs, the reference's ref as numpy leaves)."""
    mod = jprim.WORKLOADS[name]
    if name == "HST-L":
        inputs = mod.make_inputs(_n(name), KEY, bins=mod.BINS_L)
    else:
        inputs = mod.make_inputs(_n(name), KEY)
    want = [np.asarray(w) for w in jax.tree.leaves(mod.ref(**inputs))]
    return inputs, want


def _torch(v):
    if isinstance(v, (list, tuple)):
        return [_torch(u) for u in v]
    if isinstance(v, int):
        return v
    return torch.from_numpy(np.array(v))


def _port_inputs(name):
    return {k: _torch(v) for k, v in _jax_case(name)[0].items()}


def _leaves(x):
    return [t.numpy() for t in (x if isinstance(x, tuple) else (x,))]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype.kind in "iu" and a.itemsize == 4 \
        else a


def _assert_same(name, got, want, inputs):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape, (g.shape, w.shape)
        if name == "SpMV":
            x, cols, vals = (np.asarray(inputs[k]) for k in ("x", "cols",
                                                             "vals"))
            scale = np.abs(vals * x[cols]).sum(1)
            assert np.all(np.abs(g - w) <= SPMV_RTOL * scale)
        else:
            np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("banks", [1, 8])
@pytest.mark.parametrize("name", NAMES)
def test_run_pim_matches_reference_ref(name, banks):
    inputs, want = _jax_case(name)
    got = prim.WORKLOADS[name].run_pim(BankGrid(banks, "cpu"),
                                       **_port_inputs(name))
    _assert_same(name, _leaves(got), want, inputs)


@pytest.mark.parametrize("name", NAMES)
def test_ref_matches_reference_ref(name):
    inputs, want = _jax_case(name)
    got = prim.WORKLOADS[name].ref(**_port_inputs(name))
    _assert_same(name, _leaves(got), want, inputs)


@pytest.mark.parametrize("name", [n for n in NAMES if n not in ("SEL",
                                                                "UNI")])
def test_run_pim_matches_reference_run_pim(name, bank_grid):
    """One bank, against the reference's bank-parallel run itself (SEL and
    UNI crash there: F3)."""
    inputs, _ = _jax_case(name)
    want = [np.asarray(w) for w in jax.tree.leaves(
        jprim.WORKLOADS[name].run_pim(bank_grid, **inputs))]
    got = prim.WORKLOADS[name].run_pim(BankGrid(1, "cpu"),
                                       **_port_inputs(name))
    _assert_same(name, _leaves(got), want, inputs)


@pytest.mark.parametrize("banks", [1, 4])
def test_ts_scores_no_window_past_the_end(banks):
    """F5: a series whose best match would lie in the zero halo of the last
    bank. The reference's run_pim returns (0, 63) here; `ref`, which has
    only 57 windows, returns (25340, 1), and so must the port."""
    rng = np.random.default_rng(5)
    series = rng.integers(50, 100, size=64).astype(np.int32)
    query = np.zeros(8, np.int32)
    query[0] = series[-1]
    want = [np.asarray(w) for w in jts.ref(jnp.asarray(series),
                                          jnp.asarray(query))]
    got = prim.ts.run_pim(BankGrid(banks, "cpu"), torch.from_numpy(series),
                          torch.from_numpy(query))
    _assert_same("TS", _leaves(got), want, {})
    assert int(want[1]) < 64 - 8 + 1
    _assert_same("TS", _leaves(prim.ts.ref(torch.from_numpy(series),
                                           torch.from_numpy(query))),
                 want, {})


# the integer ranges [lo, hi) of the reference's make_inputs
RANGES = {"a": (-1000, 1000), "b": (-1000, 1000), "A": (0, 64),
          "x": (0, 64), "cols": (0, 1024), "arr": (0, 2**30),
          "queries": (0, 2**30), "series": (-100, 100), "query": (-100, 100),
          "adj": (0, 128), "src": (0, 1), "ws": (-4, 5)}
RANGES_BY = {"SEL": {"x": (0, 2**30)}, "UNI": {"x": (0, 256)},
             "MLP": {"x": (-4, 5)}, "NW": {"a": (0, 4), "b": (0, 4)},
             "HST-S": {"x": (0, 4096)}, "HST-L": {"x": (0, 4096)},
             "RED": {"x": (-1000, 1000)}, "SCAN-SSA": {"x": (-100, 100)},
             "SCAN-RSS": {"x": (-100, 100)}, "TRNS": {"A": (-1000, 1000)}}


@pytest.mark.parametrize("name", NAMES)
def test_make_inputs_match_the_reference(name):
    """The port draws its own values (torch.Generator) with the shapes,
    dtypes (the reference's as it runs: int64 -> int32; uint32 GEMV as its
    int32 bits) and integer ranges of the reference's; its run agrees with
    its ref on them."""
    jin, _ = _jax_case(name)
    gen = torch.Generator().manual_seed(0)
    tin = prim.make_inputs(name, _n(name), gen, "cpu")
    assert set(tin) == set(jin)
    for k in jin:
        if isinstance(jin[k], int):
            assert tin[k] == jin[k]
            continue
        js = jin[k] if isinstance(jin[k], list) else [jin[k]]
        ts = tin[k] if isinstance(tin[k], list) else [tin[k]]
        assert len(js) == len(ts)
        for j, t in zip(js, ts):
            j, t = np.asarray(j), t.numpy()
            assert t.shape == j.shape, k
            assert t.dtype == (np.int32 if name == "GEMV" else j.dtype), k
            if j.dtype.kind in "iu":
                lo, hi = RANGES_BY.get(name, {}).get(k, RANGES[k])
                for v in (j, t):
                    assert lo <= v.min() and v.max() < hi, (k, lo, hi)
    mod = prim.WORKLOADS[name]
    _assert_same(name, _leaves(mod.run_pim(BankGrid(1, "cpu"), **tin)),
                 _leaves(mod.ref(**tin)), tin)


def test_registry_matches_the_reference():
    assert list(prim.WORKLOADS) == list(jprim.WORKLOADS)
    assert prim.SUITABLE_SET == jprim.SUITABLE_SET
    assert len(prim.SUITABLE_SET) == 10
    for name, mod in prim.WORKLOADS.items():
        jmod = jprim.WORKLOADS[name]
        assert mod.__name__.rsplit(".", 1)[1] == \
            jmod.__name__.rsplit(".", 1)[1]
        assert (mod.SUITABLE, mod.REF_N) == (jmod.SUITABLE, jmod.REF_N)
    assert (prim.hst.BINS_S, prim.hst.BINS_L) == (jprim.hst.BINS_S,
                                                  jprim.hst.BINS_L)
    assert prim.ts.M == jprim.ts.M and prim.mlp.N_LAYERS == \
        jprim.mlp.N_LAYERS
    assert prim.spmv.NNZ_PER_ROW == jprim.spmv.NNZ_PER_ROW
    assert prim.bfs.MAX_DEG == jprim.bfs.MAX_DEG
    assert (prim.nw.MATCH, prim.nw.MISMATCH, prim.nw.GAP) == \
        (jprim.nw.MATCH, jprim.nw.MISMATCH, jprim.nw.GAP)


# the exchanges of each workload's run, in order: Table I's inter-DPU
# column as the reference's phases express it (TRNS's all-to-all is an
# exchange here, inside the reference's local phase there)
PHASES = {"VA": [], "GEMV": [], "SpMV": [], "BS": [], "SEL": [],
          "UNI": ["exchange_shift"], "TS": ["exchange_shift"],
          "RED": ["exchange_reduce"], "HST-S": ["exchange_reduce"],
          "HST-L": ["exchange_reduce"],
          "SCAN-SSA": ["exchange_scan_sums"],
          "SCAN-RSS": ["exchange_scan_sums"],
          "MLP": ["exchange_gather"] * 3, "TRNS": ["exchange_all_to_all"]}


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_structure(name):
    """The FX census of a whole run at 8 banks lists exactly the
    workload's exchanges: every bank-local body is free of them."""
    mod = prim.WORKLOADS[name]
    inputs = _port_inputs(name)
    grid = BankGrid(8, "cpu")
    keys = [k for k, v in inputs.items() if isinstance(v, torch.Tensor)]
    other = {k: v for k, v in inputs.items() if k not in keys}

    def run(*tensors):
        return mod.run_pim(grid, **dict(zip(keys, tensors)), **other)
    assert census(run, *[inputs[k] for k in keys]) == PHASES[name]


def test_phase_structure_wavefronts():
    """NW exchanges its block boundaries once a wavefront step; BFS ORs
    the frontier across banks once a level."""
    grid = BankGrid(8, "cpu")
    a, b = (_port_inputs("NW")[k] for k in ("a", "b"))
    steps = 8 + 64 // 8 - 1
    assert census(lambda x, y: prim.nw.run_pim(grid, x, y), a, b) == \
        ["exchange_shift"] * steps
    adj = _port_inputs("BFS")["adj"]
    src = torch.zeros((), dtype=torch.int32)
    found = census(lambda m: prim.bfs.run_pim(grid, m, src), adj)
    dist = prim.bfs.ref(adj, src)
    levels = int(dist[dist < prim.bfs.UNSEEN].max())
    assert found == ["exchange_reduce"] * (levels + 1)


# --------------------------------------------------------------------- #
# the int32 routes' plain versions wrap as XLA's int32 does
# --------------------------------------------------------------------- #

def _planted(n, seed):
    """int32 data whose running sum crosses 2^31 several times, with a
    ragged last tile."""
    rng = np.random.default_rng(seed)
    x = rng.integers(2**28, 2**30, size=n).astype(np.int32)
    x[::7] = rng.integers(-2**31, -2**30, size=x[::7].size)
    return x


@pytest.mark.parametrize("n", [1, 8191, 3 * 8192 + 77])
def test_int32_reduction_wraps_as_xla(n):
    x = _planted(n, n)
    want = np.asarray(jnp.sum(jnp.asarray(x)))
    assert abs(int(np.sum(x, dtype=np.int64))) >= 2**31 or n == 1
    for got in (ref.reduction(torch.from_numpy(x), torch.int32),
                ops.reduction(torch.from_numpy(x), acc=torch.int32)):
        assert got.dtype == torch.int32 and got.dim() == 0
        assert int(got) == int(want)
    np.testing.assert_array_equal(
        ref.reduction(torch.from_numpy(x)).numpy(),
        np.float32(ref.reduction(torch.from_numpy(x)).item()))


@pytest.mark.parametrize("n", [1, 8191, 8192, 3 * 8192 + 77])
def test_int32_scan_wraps_as_xla(n):
    x = _planted(n, n + 1)
    want = np.asarray(jnp.cumsum(jnp.asarray(x)))
    xt = torch.from_numpy(x)
    got = ops.scan(xt, acc=torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    scans, totals = ops.scan_blocks(xt, acc=torch.int32)
    assert scans.dtype == totals.dtype == torch.int32
    assert tuple(totals.shape) == (-(-n // 8192),)
    tiles = np.zeros(totals.numel() * 8192, np.int32)
    tiles[:n] = x
    np.testing.assert_array_equal(
        totals.numpy(), np.asarray(jnp.sum(jnp.asarray(tiles.reshape(
            -1, 8192)), axis=1)))
    offs = ref.tile_offsets(totals)
    np.testing.assert_array_equal(
        ops.add_offsets(scans, offs, torch.int32).numpy(), want)
    # the f32 route keeps its contract: f32 inside, truncated to int32
    assert ops.scan(xt).dtype == torch.int32


@pytest.mark.parametrize("m,k", [(7, 5), (64, 300)])
def test_int32_gemv_wraps_as_xla(m, k):
    rng = np.random.default_rng(m * k)
    A = rng.integers(-2**31, 2**31, size=(m, k), dtype=np.int64) \
        .astype(np.int32)
    x = rng.integers(-2**31, 2**31, size=k, dtype=np.int64).astype(np.int32)
    want = np.asarray(jnp.dot(jnp.asarray(A), jnp.asarray(x)))
    got = ops.gemv(torch.from_numpy(A), torch.from_numpy(x),
                   acc=torch.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the same bits as uint32 (PrIM GEMV's type)
    wu = np.asarray(jnp.dot(jnp.asarray(A.view(np.uint32)),
                            jnp.asarray(x.view(np.uint32))))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), wu)


def test_int32_routes_refuse_other_inputs():
    i32, f32 = torch.zeros(8, dtype=torch.int32), torch.zeros(8)
    bad = [
        lambda: ops.reduction(f32, acc=torch.int32),
        lambda: ops.reduction(i32, acc=torch.int64),
        lambda: ops.scan(f32, acc=torch.int32),
        lambda: ops.scan_blocks(f32, acc=torch.int32),
        lambda: ops.add_offsets(i32, torch.zeros(1), torch.int32),
        lambda: ops.add_offsets(i32, torch.zeros(1, dtype=torch.int32),
                                torch.float32),
        lambda: ops.add_offsets(i32, torch.zeros(2, dtype=torch.int32),
                                torch.int32),
        lambda: ops.gemv(torch.zeros(4, 8), f32, acc=torch.int32),
        lambda: ops.gemv(torch.zeros(4, 8, dtype=torch.int32), i32[:7],
                         acc=torch.int32),
        lambda: ops.gemv(torch.zeros(4, 8, dtype=torch.int32), i32),
    ]
    for i, call in enumerate(bad):
        with pytest.raises(ValueError):
            call()
            pytest.fail(f"case {i} did not raise")


def test_int32_cuda_routes_refuse_cpu_tensors():
    """The kernel wrappers launch or raise; the int32 routes too."""
    i32 = torch.zeros(8, dtype=torch.int32)
    for call in (lambda: kred.reduction(i32, torch.int32),
                 lambda: kscan.scan_blocks(i32, torch.int32),
                 lambda: kscan.add_offsets(i32, i32[:1], torch.int32),
                 lambda: kgemv.gemv(i32.view(1, 8), i32)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    for kern in (kred.KERNEL, kscan.SCAN_BLOCKS, kscan.ADD_OFFSETS,
                 kgemv.KERNEL):
        assert kern.launches == 0 and not kern.route_launches


def test_batched_transpose_plain_version():
    A = torch.arange(3 * 5 * 7, dtype=torch.int32).view(3, 5, 7)
    got = ops.transpose(A)
    assert got.shape == (3, 7, 5) and got.is_contiguous()
    for i in range(3):
        assert torch.equal(got[i], A[i].t())
