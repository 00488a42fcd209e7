"""The port's PrIM bank-local kernels on the CPU (their plain PyTorch
versions, reached through `repro_torch.kernels.ops`) against the
reference's Pallas kernels in interpret mode (`repro.kernels.ops` and the
pair `repro.kernels.scan_block.scan_blocks` / `add_offsets`) and its
`kernels/ref.py`, over the sweeps of tests/test_kernels.py. The CUDA
kernels run only on the card (chip_smoke.py phase 8); here their wrappers
are held to their argument checks.

Tolerances:

| Kernel | Tolerance |
|---|---|
| scan, integer data (int32, or integer-valued f32) | exact |
| scan, normal f32 data | 1e-5 of max |prefix| (XLA's CPU cumsum sums in another order than the port's doubling scan) |
| histogram and transpose | exact |
| ts, integer data | exact |
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import scan_block as jscan
from repro_torch import bridge
from repro_torch.kernels import histogram as khst
from repro_torch.kernels import ops, ref
from repro_torch.kernels import scan_block as kscan
from repro_torch.kernels import trns as ktrns
from repro_torch.kernels import ts as kts

SCAN_F32_TOL = 1e-5     # of max |prefix|


def _pair(a):
    """numpy array -> (jax array, torch CPU tensor with the same bits)."""
    j = jnp.asarray(a)
    return j, bridge.tensor_from_numpy(np.asarray(j), "cpu")


def _ints(rng, shape, lo, hi, dtype=np.int32):
    return _pair(rng.integers(lo, hi, size=shape).astype(dtype))


@pytest.mark.parametrize("n", [8192, 50_000, 128])
@pytest.mark.parametrize("data", ["int32", "int_valued_f32"])
def test_scan_integer_data_exact(n, data):
    rng = np.random.default_rng(5)
    xj, xt = _ints(rng, n, -10, 10,
                   np.int32 if data == "int32" else np.float32)
    got = ops.scan(xt)
    assert got.dtype == xt.dtype and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.scan(xj, interpret=True)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.cumsum(xj)))


@pytest.mark.parametrize("n", [8192, 50_000, 128])
def test_scan_normal_f32(n):
    rng = np.random.default_rng(6)
    xj, xt = _pair(rng.normal(size=n).astype(np.float32))
    got = ops.scan(xt).numpy()
    exact = np.cumsum(np.asarray(xj, np.float64))
    tol = SCAN_F32_TOL * np.abs(exact).max()
    for want in (jops.scan(xj, interpret=True), jref.scan(xj)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def test_scan_prim_data_int32_exact():
    """PrIM's SCAN-SSA data (int32 in [-100, 100)) over several tiles and a
    ragged tail: the f32 phases are exact while |prefix| < 2^24."""
    rng = np.random.default_rng(7)
    xj, xt = _ints(rng, 5 * 8192 + 77, -100, 100)
    np.testing.assert_array_equal(ops.scan(xt).numpy(),
                                  np.asarray(jops.scan(xj, interpret=True)))


@pytest.mark.parametrize("rows", [64, 128, 448])
@pytest.mark.parametrize("data", ["ints", "normal"])
def test_scan_pair_matches_reference(rows, data):
    """The pair functions against the reference's `scan_blocks` and
    `add_offsets` on the (R, 128) tiles they take, tile totals included."""
    rng = np.random.default_rng(rows)
    if data == "ints":
        xj, xt = _ints(rng, (rows, 128), -100, 100)
    else:
        xj, xt = _pair(rng.normal(size=(rows, 128)).astype(np.float32))
    sj, tj = jscan.scan_blocks(xj, interpret=True)
    st, tt = ref.scan_blocks(xt.reshape(-1))
    assert st.dtype == tt.dtype == torch.float32
    assert tuple(tt.shape) == (rows // 64,)
    tol = 0 if data == "ints" else SCAN_F32_TOL * float(
        np.abs(np.asarray(sj)).max())
    np.testing.assert_allclose(st.numpy(), np.asarray(sj).reshape(-1),
                               rtol=0, atol=tol)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=tol)
    oj, ot = _pair(rng.normal(size=rows // 64).astype(np.float32) * 100)
    got = ref.add_offsets(st, ot)
    want = jscan.add_offsets(sj, oj, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(-1),
                               rtol=0, atol=tol + 1e-4)
    np.testing.assert_array_equal(
        got.numpy(), (st.reshape(-1, 8192) + ot[:, None]).reshape(-1).numpy())


def test_scan_ragged_tail_counts_as_zero_padding():
    """The plain pair masks the last tile: its scans and total equal the
    reference's on the zero-padded array."""
    rng = np.random.default_rng(8)
    n = 8192 + 300
    x = rng.integers(-100, 100, size=n).astype(np.int32)
    padded = np.zeros(2 * 8192, np.int32)
    padded[:n] = x
    sj, tj = jscan.scan_blocks(jnp.asarray(padded.reshape(-1, 128)),
                               interpret=True)
    st, tt = ref.scan_blocks(torch.from_numpy(x))
    assert tuple(st.shape) == (n,)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj).reshape(-1)[:n])
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    offsets = ref.tile_offsets(tt)
    np.testing.assert_array_equal(offsets.numpy(),
                                  np.asarray(jnp.cumsum(tj) - tj))
    got = ref.add_offsets(st, offsets, torch.int32)
    np.testing.assert_array_equal(got.numpy(), np.cumsum(x))


@pytest.mark.parametrize("data", ["ints", "normal"])
def test_tile_offsets_match_reference(data):
    """The offsets between the phases over PrIM's 16384 tile totals (2^27
    elements): the fixed-order scan of the totals minus the totals, held to
    the reference's `jnp.cumsum(totals) - totals` (exact on integer sums
    below 2^24, else within the scan's f32 band)."""
    rng = np.random.default_rng(16)
    if data == "ints":
        tj, tt = _ints(rng, 16384, -1000, 1000, np.float32)
    else:
        tj, tt = _pair((rng.normal(size=16384) * 100).astype(np.float32))
    got = ref.tile_offsets(tt)
    assert got.dtype == torch.float32 and tuple(got.shape) == (16384,)
    np.testing.assert_array_equal(
        got.numpy(), (ref._cumsum_doubling(tt) - tt).numpy())
    want = np.asarray(jnp.cumsum(tj) - tj)
    exact = np.cumsum(np.asarray(tj, np.float64)) - np.asarray(tj, np.float64)
    tol = 0 if data == "ints" else SCAN_F32_TOL * np.abs(exact).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_scan_f32_to_int32_truncates():
    scans = torch.tensor([1.75, -1.75, 2.5, -0.5])
    got = ref.add_offsets(scans, torch.tensor([0.0]), torch.int32)
    np.testing.assert_array_equal(got.numpy(), [1, -1, 2, 0])


@pytest.mark.parametrize("n,bins", [(30_000, 256), (8192, 1024),
                                    (4096, 4096)])
def test_histogram(n, bins):
    rng = np.random.default_rng(9)
    xj, xt = _ints(rng, n, 0, 1 << 12, np.uint32)
    assert xt.dtype == torch.uint32
    got = ops.histogram(xt, bins)
    assert got.dtype == torch.int32 and tuple(got.shape) == (bins,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.histogram(xj, bins, 12)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.histogram(xj, bins, interpret=True)))
    assert int(got.sum()) == n
    # int32 holding the same bits counts the same
    np.testing.assert_array_equal(ops.histogram(xt.view(torch.int32),
                                                bins).numpy(), got.numpy())


def test_histogram_out_of_range_is_dropped():
    """Buckets >= bins count nowhere, as in the reference's one-hot and its
    scatter: at 256 bins, 1 -> bin 0, 4095 -> bin 255, and 4096, 70000 and
    2^32 - 1 (whose product wraps) land past the last bin."""
    xj, xt = _pair(np.array([1, 4095, 4096, 70000, 2**32 - 1], np.uint32))
    got = ops.histogram(xt, 256)
    want = np.zeros(256, np.int32)
    want[0] = want[255] = 1
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.histogram(xj, 256, 12)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.histogram(xj, 256, interpret=True)))


def test_histogram_wrapping_products():
    """Values over the whole uint32 range: (x * bins) wraps in uint32."""
    rng = np.random.default_rng(10)
    xj, xt = _pair(rng.integers(0, 2**32, size=20_000, dtype=np.uint64)
                   .astype(np.uint32))
    for bins in (3, 256, 4096):
        np.testing.assert_array_equal(
            ops.histogram(xt, bins).numpy(),
            np.asarray(jref.histogram(xj, bins, 12)))


@pytest.mark.parametrize("n,m", [(5000, 8), (2048, 16), (512, 4)])
def test_ts(n, m):
    rng = np.random.default_rng(11)
    sj, st = _ints(rng, n, -100, 100)
    qj, qt = _ints(rng, m, -100, 100)
    dists = ref.ts_dists(st, qt)
    assert dists.dtype == torch.float32 and tuple(dists.shape) == (n - m + 1,)
    np.testing.assert_array_equal(dists.numpy(),
                                  np.asarray(jref.ts_dists(sj, qj)))
    d, i = ops.ts_min(st, qt)
    dj, ij = jops.ts_min(sj, qj, interpret=True)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert d.dim() == 0 and i.dim() == 0
    assert float(d) == float(dj) and int(i) == int(ij)


def test_ts_tie_takes_the_first_window():
    rng = np.random.default_rng(12)
    s = rng.integers(-100, 100, size=4000).astype(np.int32)
    q = rng.integers(-100, 100, size=8).astype(np.int32)
    s[700:708] = q
    s[3100:3108] = q
    (sj, st), (qj, qt) = _pair(s), _pair(q)
    d, i = ops.ts_min(st, qt)
    dj, ij = jops.ts_min(sj, qj, interpret=True)
    assert float(d) == 0.0 and int(i) == 700
    assert float(dj) == 0.0 and int(ij) == 700


@pytest.mark.parametrize("n", [1, 8, 300])
def test_ts_one_window(n):
    """m = n: one window, the whole series."""
    rng = np.random.default_rng(13)
    (sj, st), (qj, qt) = (_ints(rng, n, -100, 100) for _ in range(2))
    assert tuple(ref.ts_dists(st, qt).shape) == (1,)
    d, i = ops.ts_min(st, qt)
    dj, ij = jops.ts_min(sj, qj, interpret=True)
    assert float(d) == float(dj) == float(jref.ts_dists(sj, qj)[0])
    assert int(i) == int(ij) == 0


@pytest.mark.parametrize("n,m", [(16, 32), (1, 2), (8, 9), (100, 512)])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_ts_min_query_longer_than_series(n, m, dtype):
    """m > n: no window, so (inf, 0) as the reference's ts_min gives, as a
    0-dim f32 and a 0-dim int32; m > 512 and n = 0 still raise, as the
    reference asserts m <= BLOCK and has no argmin of nothing."""
    rng = np.random.default_rng(n * m)
    (sj, st), (qj, qt) = (_ints(rng, k, -100, 100, dtype) for k in (n, m))
    d, i = ops.ts_min(st, qt)
    dj, ij = jops.ts_min(sj, qj, interpret=True)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    assert d.dim() == 0 and i.dim() == 0
    assert float(d) == float(dj) == float("inf")
    assert int(i) == int(ij) == 0
    with pytest.raises(ValueError):
        ops.ts_min(st, torch.zeros(kts.MAX_M + 1, dtype=st.dtype))
    with pytest.raises(ValueError):
        ops.ts_min(st[:0], qt)


def test_ts_float_sums_each_step_in_order():
    """f32 data: the plain version adds d*d window by window in j order,
    rounding the product and the sum separately, as the Pallas body."""
    rng = np.random.default_rng(14)
    s = (rng.normal(size=700) * 10).astype(np.float32)
    q = (rng.normal(size=16) * 10).astype(np.float32)
    want = np.zeros(700 - 16 + 1, np.float32)
    for j in range(16):
        d = s[j:j + want.size] - q[j]
        want = want + d * d
    got = ref.ts_dists(torch.from_numpy(s), torch.from_numpy(q))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jref.ts_dists(jnp.asarray(s), jnp.asarray(q))),
        rtol=1e-6)


@pytest.mark.parametrize("m,n", [(128, 128), (200, 300), (512, 384)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_transpose(m, n, dtype):
    rng = np.random.default_rng(15)
    Aj, At = _ints(rng, (m, n), -99, 99, dtype)
    got = ops.transpose(At)
    assert got.dtype == At.dtype and tuple(got.shape) == (n, m)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.trns(Aj)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jops.transpose(Aj,
                                                            interpret=True)))


def test_prim_wrappers_reject_bad_arguments():
    i32, f32 = torch.zeros(8, dtype=torch.int32), torch.zeros(8)
    u32 = i32.view(torch.uint32)
    bad = [
        lambda: ops.scan(f32.double()),                    # dtype
        lambda: ops.scan(torch.zeros(4, 2)),               # not 1-D
        lambda: ops.histogram(f32, 16),                    # dtype
        lambda: ops.histogram(u32[None], 16),              # not 1-D
        lambda: ops.histogram(u32, 0),                     # bins
        lambda: ops.histogram(u32, khst.MAX_BINS + 1),
        lambda: ops.histogram(u32, 16.0),
        lambda: ops.histogram(u32, True),
        lambda: ops.ts_min(torch.zeros(600, dtype=torch.int32),
                           torch.zeros(513, dtype=torch.int32)),      # m
        lambda: ops.ts_min(i32, torch.zeros(0, dtype=torch.int32)),
        lambda: ops.ts_min(i32.double(), i32),             # dtype
        lambda: ops.transpose(f32),                        # not 2-D
        lambda: ops.transpose(torch.zeros(4, 4).double()),  # dtype
    ]
    for i, call in enumerate(bad):
        with pytest.raises(ValueError):
            call()
            pytest.fail(f"case {i} did not raise")


def test_prim_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: handed CPU tensors they raise
    before building anything."""
    i32, f32 = torch.zeros(8, dtype=torch.int32), torch.zeros(8)
    for call in (lambda: kscan.scan_blocks(i32),
                 lambda: kscan.add_offsets(f32, torch.zeros(1)),
                 lambda: khst.histogram(i32, 16),
                 lambda: kts.ts_dists(i32, i32[:4]),
                 lambda: ktrns.transpose(torch.zeros(4, 4))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    for kern in (kscan.SCAN_BLOCKS, kscan.ADD_OFFSETS, khst.KERNEL,
                 kts.KERNEL, ktrns.KERNEL):
        assert kern.launches == 0
    assert set(ops.kernels()) >= {"scan_blocks", "add_offsets", "histogram",
                                  "ts_dists", "transpose"}


@pytest.mark.parametrize("name", ["scan", "histogram", "transpose"])
def test_prim_ops_take_empty_inputs(name):
    """n = 0 (and M = 0) give empty results, as the reference's wrappers."""
    if name == "scan":
        assert tuple(ops.scan(torch.zeros(0, dtype=torch.int32)).shape) == (0,)
    elif name == "histogram":
        got = ops.histogram(torch.zeros(0, dtype=torch.int32), 16)
        np.testing.assert_array_equal(got.numpy(), np.zeros(16, np.int32))
    else:
        assert tuple(ops.transpose(torch.zeros(0, 5)).shape) == (5, 0)
