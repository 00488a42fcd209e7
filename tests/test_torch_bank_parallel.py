"""The port's bank grid (`repro_torch.core.bank_parallel`) on the CPU:
every exchange against a numpy statement of the reference's collective
(`repro.core.bank_parallel`: psum/pmax/pmin, all_gather, the masked
exclusive scan, ppermute, all_to_all) at 1, 3 and 8 banks; local phases
per bank and batched; and `assert_local`, the twin of
tests/test_prim_multibank.py::test_phase_discipline_assert_local. All
comparisons are exact (integer data; the float cases add or compare
values that are exact in f32)."""

import numpy as np
import pytest
import torch

from repro_torch.core.bank_parallel import (BANKS, BankGrid, assert_local,
                                            census)

BANK_COUNTS = [1, 3, 8]


def _shards(x, b):
    return np.asarray(x).reshape(b, -1, *np.asarray(x).shape[1:])


def _data(b, per=4, tail=(), dtype=np.int32, seed=0):
    rng = np.random.default_rng(seed + b)
    return rng.integers(-1000, 1000, size=(b * per, *tail)).astype(dtype)


@pytest.mark.parametrize("b", BANK_COUNTS)
@pytest.mark.parametrize("op", ["add", "max", "min"])
def test_exchange_reduce(b, op):
    x = _data(b, tail=(3,))
    grid = BankGrid(b, "cpu")
    got = grid.exchange_reduce(torch.from_numpy(x), op).numpy()
    s = _shards(x, b)
    r = {"add": s.sum(0), "max": s.max(0), "min": s.min(0)}[op]
    np.testing.assert_array_equal(got, np.concatenate([r] * b))
    assert got.dtype == np.int32


def test_exchange_reduce_int32_wraps():
    """A psum of int32 (x64 off) wraps at 2^32; so does the port's."""
    x = np.array([2**31 - 1, 1, 2**31 - 1, 2], np.int32)
    got = BankGrid(4, "cpu").exchange_reduce(torch.from_numpy(x)).numpy()
    want = np.int32((2**31 - 1) * 2 + 3 - 2**32)
    np.testing.assert_array_equal(got, np.full(4, want, np.int32))


@pytest.mark.parametrize("b", BANK_COUNTS)
def test_exchange_gather(b):
    x = _data(b, tail=(2,))
    got = BankGrid(b, "cpu").exchange_gather(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("b", BANK_COUNTS)
def test_exchange_scan_sums(b):
    """Bank i receives the sum of banks [0, i) (the reference's masked
    sum over the gathered values)."""
    x = _data(b, per=2)
    got = BankGrid(b, "cpu").exchange_scan_sums(torch.from_numpy(x))
    s = _shards(x, b)
    want = np.stack([s[:i].sum(0) if i else np.zeros_like(s[0])
                     for i in range(b)])
    np.testing.assert_array_equal(got.numpy(), want.reshape(-1))


@pytest.mark.parametrize("b", BANK_COUNTS)
@pytest.mark.parametrize("offset", [1, -1, 2])
def test_exchange_shift(b, offset):
    """ppermute with pairs (i, i + offset): bank i gets bank i - offset's
    shard; banks without a sender get zeros."""
    x = _data(b, tail=(3,))
    got = BankGrid(b, "cpu").exchange_shift(torch.from_numpy(x), offset)
    s = _shards(x, b)
    want = np.zeros_like(s)
    for i in range(b):
        if 0 <= i - offset < b:
            want[i] = s[i - offset]
    np.testing.assert_array_equal(got.numpy(), want.reshape(x.shape))


@pytest.mark.parametrize("b", BANK_COUNTS)
@pytest.mark.parametrize("split_axis", [0, 1])
def test_exchange_all_to_all(b, split_axis):
    """Chunk j of every bank's shard goes to bank j, concatenated in the
    senders' order (all_to_all, split_axis, concat_axis=0, tiled)."""
    x = _data(b, per=2 * b, tail=(3 * b,))
    got = BankGrid(b, "cpu").exchange_all_to_all(torch.from_numpy(x),
                                                 split_axis).numpy()
    s = _shards(x, b)
    want = [np.concatenate([np.split(s[i], b, axis=split_axis)[j]
                            for i in range(b)]) for j in range(b)]
    np.testing.assert_array_equal(got, np.concatenate(want))


def test_trns_by_exchange_and_batched_local():
    """The exchange and a batched local transpose give A.T (TRNS's
    phases), at 1 and 8 banks."""
    A = torch.from_numpy(_data(8, per=8, tail=(64,)))
    for b in (1, 8):
        grid = BankGrid(b, "cpu")
        recv = grid.exchange_all_to_all(A, split_axis=1)
        got = grid.local(lambda t: t.transpose(1, 2).contiguous(),
                         batched=True)(recv)
        assert torch.equal(got, A.t())


@pytest.mark.parametrize("b", BANK_COUNTS)
def test_local_per_bank_and_batched_agree(b):
    """A per-bank phase sees each bank's shard and the replicated args
    whole; outputs split over banks are concatenated in bank order,
    replicated ones come from bank 0. Batched, the body sees the stacked
    shards."""
    grid = BankGrid(b, "cpu")
    x = torch.from_numpy(_data(b, per=5))
    w = torch.tensor([3, -1], dtype=torch.int32)
    seen = []

    def body(xb, wb, bank):
        seen.append((tuple(xb.shape), bank))
        return xb * wb[0] + wb[1], xb.sum(dtype=torch.int32)[None], wb
    y, sums, w_out = grid.local(body, in_specs=(BANKS, None, BANKS),
                                out_specs=(BANKS, BANKS, None))(
        x, w, grid.bank_ids())
    assert seen == [((5,), i) for i in range(b)]
    assert torch.equal(y, x * 3 - 1) and torch.equal(w_out, w)
    assert torch.equal(sums, grid.split(x).sum(1, dtype=torch.int32))
    yb = grid.local(lambda xs, wb: xs * wb[0] + wb[1],
                    in_specs=(BANKS, None), batched=True)(x, w)
    assert torch.equal(yb, y)


def test_grid_refuses_what_it_cannot_split():
    grid = BankGrid(3, "cpu")
    with pytest.raises(ValueError):
        grid.split(torch.zeros(7))
    with pytest.raises(ValueError):
        grid.exchange_all_to_all(torch.zeros(6, 4), split_axis=1)
    with pytest.raises(ValueError):
        grid.local(lambda v: v)(torch.zeros(3), [0, 1])   # host values
    with pytest.raises(ValueError):
        grid.local(lambda v: v, in_specs=BANKS)([0, 1])
    with pytest.raises(ValueError):
        grid.exchange_reduce(torch.zeros(3), op="mean")
    with pytest.raises(ValueError):
        BankGrid(0, "cpu")


def test_grid_refuses_arrays_off_its_device():
    """A phase of banks on the card never runs a CPU array (and the
    reverse): the PrIM path cannot fall back to the host unasked."""
    grid = BankGrid(2, "cpu")
    grid.device = torch.device("cuda")       # as a grid on the card
    with pytest.raises(ValueError, match="cpu"):
        grid.local(lambda v: v)(torch.zeros(4))


def test_phase_discipline_assert_local():
    """assert_local flags an exchange or a collective inside a 'bank-local'
    phase (the twin of the reference's test on 8 banks)."""
    grid = BankGrid(8, "cpu")
    x = torch.arange(64, dtype=torch.float32)
    legal = grid.local(lambda v: v * 2)
    assert_local(legal, x)      # must pass
    assert census(legal, x) == []
    illegal = grid.local(lambda v: grid.exchange_reduce(v))
    with pytest.raises(AssertionError, match="exchange_reduce"):
        assert_local(illegal, x)
    with pytest.raises(AssertionError, match="all_reduce"):
        assert_local(grid.local(lambda v: torch.distributed.all_reduce(v)),
                     x)
    # the census restores the grid and torch.distributed afterwards
    assert BankGrid.exchange_reduce.__name__ == "exchange_reduce"
    assert torch.distributed.all_reduce.__name__ == "all_reduce"


def test_census_lists_a_workloads_exchanges_in_order():
    grid = BankGrid(4, "cpu")

    def red(x):
        part = grid.local(lambda v: v.sum(dtype=torch.int32)[None])(x)
        offs = grid.exchange_scan_sums(part)
        return grid.exchange_reduce(offs)[0]
    x = torch.arange(16, dtype=torch.int32)
    assert census(red, x) == ["exchange_scan_sums", "exchange_reduce"]
    assert int(red(x)) == 0 + 6 + (6 + 22) + (6 + 22 + 38)
