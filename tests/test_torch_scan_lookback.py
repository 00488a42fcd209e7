"""The single-pass int32 scan (`csrc/scan.cu`, `scan_lookback`) on the CPU:
its plain version, reached through `ops.scan(x, acc=torch.int32)` and
`ops.scan_add`, against the reference's int32 scan with x64 off
(`jnp.cumsum`, plus the carry as `repro/prim/scan_rss.py` adds it); the
wrappers' argument checks; the kernel's launch plan; the look-back
protocol, simulated block by block under random schedules; and SCAN-SSA and
SCAN-RSS, which run on it, against `repro.prim`'s `ref`. The CUDA kernel
runs only on the card (chip_smoke.py phases 8 and 9).

Tolerance: none. Every add wraps at 2^32 and addition mod 2^32 is
associative, so the port and XLA must give the same bits.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import prim as jprim
from repro_torch import prim
from repro_torch.core.bank_parallel import BankGrid, census
from repro_torch.kernels import _build, ops
from repro_torch.kernels import scan_block as kscan

TILE = kscan.TILE            # the pair's tile
LB_TILE = kscan.LOOKBACK_TILE   # the single-pass kernel's
CARRIES = [None, 0, 2**31 - 1, -2**31, 123_456_789]
LENGTHS = sorted({1, 31, TILE - 1, TILE, TILE + 1, LB_TILE - 1, LB_TILE,
                  LB_TILE + 1, 3 * LB_TILE + 77})


def _data(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "prim":          # SCAN-SSA/RSS's data
        return rng.integers(-100, 100, size=n).astype(np.int32)
    # running sums that cross 2^31 again and again
    x = rng.integers(2**28, 2**30, size=n).astype(np.int32)
    x[::5] = rng.integers(-2**31, -2**30, size=x[::5].size)
    return x


def _xla(x, carry):
    """The reference's arithmetic: jnp.cumsum of int32 (x64 off), plus
    ob[0] as SCAN-RSS's phase 3 adds it."""
    s = jnp.cumsum(jnp.asarray(x))
    assert s.dtype == jnp.int32
    if carry is not None:
        s = s + jnp.asarray(np.array([carry], np.int32))[0]
    return np.asarray(s)


def _carry(c):
    return None if c is None else torch.tensor([c], dtype=torch.int32)


@pytest.mark.parametrize("carry", CARRIES)
@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("kind", ["prim", "wrapping"])
def test_plain_single_pass_equals_xla(kind, n, carry):
    x = _data(kind, n, n)
    want = _xla(x, carry)
    xt = torch.from_numpy(x)
    got = ops.scan_add(xt, _carry(carry))
    assert got.dtype == torch.int32 and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    if carry is None:
        np.testing.assert_array_equal(
            ops.scan(xt, acc=torch.int32).numpy(), want)


def test_wrapping_data_does_wrap():
    """The wrapping cases cross 2^31: a sum in int64 differs from the
    int32 one, so the equality above is not an int64 scan's."""
    x = _data("wrapping", 3 * TILE + 77, 0).astype(np.int64)
    wide = np.cumsum(x)
    assert wide.max() > 2**31 or wide.min() < -2**31
    assert not np.array_equal(wide, _xla(x.astype(np.int32), None))


def test_carry_read_from_a_view():
    """The carry may be a one-element view into a larger array (a bank's
    slice of the exchanged offsets)."""
    x = _data("prim", 1000, 1)
    offsets = torch.tensor([5, -7, 2**31 - 1], dtype=torch.int32)
    for b in range(3):
        np.testing.assert_array_equal(
            ops.scan_add(torch.from_numpy(x), offsets[b:b + 1]).numpy(),
            _xla(x, int(offsets[b])))


def test_empty_input():
    got = ops.scan_add(torch.zeros(0, dtype=torch.int32), _carry(3))
    assert got.dtype == torch.int32 and tuple(got.shape) == (0,)


BAD = {
    "f32 x": (torch.zeros(8), None),
    "int64 x": (torch.zeros(8, dtype=torch.int64), None),
    "2-D x": (torch.zeros(4, 2, dtype=torch.int32), None),
    "f32 carry": (torch.zeros(8, dtype=torch.int32), torch.zeros(1)),
    "int64 carry": (torch.zeros(8, dtype=torch.int32),
                    torch.zeros(1, dtype=torch.int64)),
    "two carries": (torch.zeros(8, dtype=torch.int32),
                    torch.zeros(2, dtype=torch.int32)),
    "no carry element": (torch.zeros(8, dtype=torch.int32),
                         torch.zeros(0, dtype=torch.int32)),
    "carry on another device": (torch.zeros(8, dtype=torch.int32),
                                torch.zeros(1, dtype=torch.int32,
                                            device="meta")),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrappers_reject_bad_arguments(case):
    x, carry = BAD[case]
    with pytest.raises(ValueError):
        ops.scan_add(x, carry)
    with pytest.raises(ValueError):
        kscan.check_lookback(x, carry)
    with pytest.raises(ValueError):    # CPU tensors, or the same faults
        kscan.scan_lookback(x, carry)


def test_kernel_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the kernel's wrapper raises before building or
    launching anything; `ops.kernels()` lists the kernel."""
    kscan.LOOKBACK.reset()
    x = torch.zeros(8, dtype=torch.int32)
    for carry in (None, torch.zeros(1, dtype=torch.int32)):
        with pytest.raises(ValueError, match="CUDA"):
            kscan.scan_lookback(x, carry)
    assert kscan.LOOKBACK.launches == 0 and not kscan.LOOKBACK.route_launches
    assert ops.kernels()["scan_lookback"] is kscan.LOOKBACK


# --------------------------------------------------------------------- #
# the launch plan
# --------------------------------------------------------------------- #

def _constant(name):
    src = (_build.CSRC / "scan.cu").read_text()
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", src).group(1))


def test_plan_constants_match_the_source():
    """The Python plan's tile is csrc/scan.cu's: kLookbackRows rows of
    kLanes, covered by the block's warps, each lane holding 4 elements of
    each of its warp's rows; warp 0 scans the row totals, a whole number
    of them a lane."""
    lanes, rows, warps = (_constant(k) for k in ("kLanes", "kLookbackRows",
                                                  "kWarps"))
    assert lanes * rows == LB_TILE
    assert warps * 32 * 4 * (rows // warps) == LB_TILE
    assert rows % warps == 0 and rows % 32 == 0


@pytest.mark.parametrize("n", [1, 31, LB_TILE - 1, LB_TILE, LB_TILE + 1,
                               2**20 + 3, 2**22, 2**27, 2**27 + 5,
                               kscan.MAX_TILES * LB_TILE])
def test_plan_covers_every_element_once(n):
    plan = kscan.lookback_plan(n)
    assert (plan.tiles - 1) * LB_TILE < n <= plan.tiles * LB_TILE
    assert plan.scratch_words == plan.tiles + 1   # counter + a word a tile


@pytest.mark.parametrize("n", [0, -1, kscan.MAX_TILES * LB_TILE + 1])
def test_plan_refuses_sizes_the_kernel_refuses(n):
    with pytest.raises(ValueError):
        kscan.lookback_plan(n)


# --------------------------------------------------------------------- #
# the look-back protocol, simulated
# --------------------------------------------------------------------- #

INVALID, AGGREGATE, PREFIX = 0, 1, 2
MASK = 2**32 - 1


def _block(tile_of, status, totals, carry, result, rng):
    """One block of the kernel, as a generator that yields between the
    steps other blocks may interleave with: take a tile, publish its
    aggregate, look back in windows of 32 words (the lanes' loads land in
    random groups, so a window is no snapshot), publish its prefix."""
    tile = tile_of()
    yield
    total = totals[tile]
    if tile == 0:
        before = carry
    else:
        status[tile] = (AGGREGATE, total)
        yield
        before, end = 0, tile
        while True:
            lanes = list(range(32))
            while True:             # spin until no word is invalid
                seen = {}
                rng.shuffle(lanes)
                for group in np.array_split(lanes, 4):
                    for lane in group:
                        idx = end - 1 - lane
                        seen[lane] = status[idx] if idx >= 0 else (PREFIX, 0)
                    yield
                if all(flag != INVALID for flag, _ in seen.values()):
                    break
            prefixes = [lane for lane in range(32) if seen[lane][0] == PREFIX]
            nearest = min(prefixes) if prefixes else 31
            before = (before + sum(seen[lane][1]
                                   for lane in range(nearest + 1))) & MASK
            if prefixes:
                break
            end -= 32
    status[tile] = (PREFIX, (before + total) & MASK)
    result[tile] = before
    yield


def _simulate(totals, carry, resident, rng, by_ticket=True, steps=200_000):
    """Run len(totals) blocks, at most `resident` at a time, each step
    advancing a random resident block; blocks are launched in an order the
    scheduler picks (reversed here, the worst case for blockIdx order).
    Returns the exclusive prefix each tile found, or None if the run did
    not finish within `steps` (a deadlock)."""
    tiles = len(totals)
    status = [(INVALID, 0)] * tiles
    result = [None] * tiles
    counter = [0]

    def ticket():
        counter[0] += 1
        return counter[0] - 1

    launch = list(reversed(range(tiles)))
    running = []
    for _ in range(steps):
        while launch and len(running) < resident:
            idx = launch.pop(0)
            tile_of = ticket if by_ticket else (lambda i=idx: i)
            running.append(_block(tile_of, status, totals, carry, result,
                                  rng))
        if not running:
            return result
        b = running[rng.integers(len(running))]
        try:
            next(b)
        except StopIteration:
            running.remove(b)
    return None


@pytest.mark.parametrize("tiles", [1, 2, 33, 100, 257])
@pytest.mark.parametrize("resident", [1, 5, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_look_back_protocol_gives_each_tile_its_prefix(tiles, resident,
                                                       seed):
    """Under any schedule every tile ends with the wrapping sum of the
    carry and all tile totals before it, and no run deadlocks."""
    rng = np.random.default_rng(seed)
    totals = [int(t) for t in rng.integers(0, 2**32, size=tiles)]
    carry = int(rng.integers(0, 2**32))
    got = _simulate(totals, carry, resident, rng)
    assert got is not None, "deadlock"
    want = (carry + np.concatenate([[0], np.cumsum(totals, dtype=np.uint64)
                                    [:-1]]).astype(np.uint64)) & MASK
    assert got == [int(w) for w in want]


def test_tiles_by_blockidx_can_deadlock():
    """Why tiles go by ticket: with one resident block launched last tile
    first, a block that took its tile from blockIdx waits forever on a
    tile whose block never runs; by ticket the same schedule finishes."""
    rng = np.random.default_rng(0)
    totals = [1] * 40
    assert _simulate(totals, 0, 1, rng, by_ticket=False,
                     steps=20_000) is None
    assert _simulate(totals, 0, 1, rng) == list(range(40))


# --------------------------------------------------------------------- #
# SCAN-SSA and SCAN-RSS on the single-pass kernel's plain version
# --------------------------------------------------------------------- #

SCAN_N = 24 * 1100      # splits over 1, 3 and 8 banks; ragged tiles
KEY = jax.random.PRNGKey(17)


@pytest.mark.parametrize("banks", [1, 3, 8])
@pytest.mark.parametrize("name", ["SCAN-SSA", "SCAN-RSS"])
@pytest.mark.parametrize("data", ["reference", "wrapping"])
def test_scan_workloads_match_reference(name, banks, data):
    jmod, mod = jprim.WORKLOADS[name], prim.WORKLOADS[name]
    if data == "reference":
        x = np.array(jmod.make_inputs(SCAN_N, KEY)["x"])
    else:
        x = _data("wrapping", SCAN_N, banks)
    assert x.dtype == np.int32
    want = np.asarray(jmod.ref(jnp.asarray(x)))
    for kern in ops.kernels().values():
        kern.reset()
    got = mod.run_pim(BankGrid(banks, "cpu"), torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert all(k.launches == 0 for k in ops.kernels().values())


@pytest.mark.parametrize("banks", [1, 3, 8])
@pytest.mark.parametrize("name", ["SCAN-SSA", "SCAN-RSS"])
def test_scan_workloads_census_unchanged(name, banks):
    """The bank-local bodies hold no exchange: the FX census of a run is
    the one exchange of Table I."""
    grid = BankGrid(banks, "cpu")
    x = torch.from_numpy(_data("prim", SCAN_N, 2))
    run = prim.WORKLOADS[name].run_pim
    assert census(lambda t: run(grid, t), x) == ["exchange_scan_sums"]
