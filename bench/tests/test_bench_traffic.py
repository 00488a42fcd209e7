"""The traffic generator: deterministic in the seed, the same sizes and
gaps for every seed (another order), inside the mix's bounds."""

import numpy as np
import pytest

from bench import traffic

DOCQA = {"rate_rps": 4.0,
         "prompt_tokens": {"dist": "loguniform", "lo": 1024, "hi": 3968},
         "output_tokens": {"dist": "uniform", "lo": 8, "hi": 32}}
DECODE = {"clients": 64,
          "prompt_tokens": {"dist": "loguniform", "lo": 128, "hi": 1024},
          "output_tokens": {"dist": "uniform", "lo": 512, "hi": 2560}}
BIG = 2**31 + 11


def _key(specs):
    return [(s.rid, s.due, s.budget, s.prompt.tolist()) for s in specs]


def test_open_loop_is_a_function_of_the_seed():
    a = traffic.open_loop(DOCQA, BIG, 50, 49155)
    b = traffic.open_loop(DOCQA, BIG, 50, 49155)
    assert _key(a) == _key(b)
    c = traffic.open_loop(DOCQA, BIG + 2, 50, 49155)
    assert _key(a) != _key(c)


def test_seeds_share_sizes_in_another_order_and_one_schedule():
    a = traffic.open_loop(DOCQA, 5, 50, 49155)
    b = traffic.open_loop(DOCQA, 2**40 + 3, 50, 49155)
    for f in (lambda s: s.prefilled, lambda s: s.budget):
        assert sorted(map(f, a)) == sorted(map(f, b))
        assert list(map(f, a)) != list(map(f, b))
    assert [s.due for s in a] == [s.due for s in b]
    # every gap is one of the exponential's stratum quantiles, each once
    n = len(a)
    want = -np.log1p(-traffic.strata(n)) / DOCQA["rate_rps"]
    for x in (a, b):
        gaps = np.diff([s.due for s in x])
        idx = np.abs(gaps[:, None] - want[None, :]).argmin(1)
        np.testing.assert_allclose(gaps, want[idx], rtol=1e-9)
        assert len(set(idx.tolist())) == n - 1


def test_open_loop_falls_due_inside_the_window():
    specs = traffic.open_loop(DOCQA, 17, 50, 49155)
    assert len(specs) == 200
    due = [s.due for s in specs]
    assert due[0] == 0.0 and due == sorted(due) and due[-1] < 50
    assert np.mean(np.diff(due)) == pytest.approx(0.25, rel=0.05)


@pytest.mark.parametrize("dist,lo,hi", [("loguniform", 1024, 3968),
                                        ("uniform", 8, 32)])
def test_lengths_cover_the_mix(dist, lo, hi):
    x = traffic.lengths({"dist": dist, "lo": lo, "hi": hi},
                        traffic.strata(1000))
    assert lo <= x.min() <= lo + 2 and hi - 0.01 * hi <= x.max() <= hi
    mid = np.median(x)
    want = np.sqrt(lo * (hi + 1)) if dist == "loguniform" else (lo + hi) / 2
    assert mid == pytest.approx(want, rel=0.02)


def test_closed_loop_starts_each_client_in_progress():
    pool = traffic.ClosedLoop(DECODE, BIG, 49155)
    first = pool.first()
    assert [s.client for s in first] == list(range(64))
    for i, s in enumerate(first):
        olen = int(pool.olen[i])
        ext = s.prefilled - int(pool.plen[i])
        assert 0 <= ext < olen and s.budget == olen - ext >= 1
        assert s.prefilled + s.budget <= 1024 + 2560
    nxt = pool.next(3)
    assert nxt.client == 3 and nxt.rid == 64
    assert nxt.prefilled == int(pool.plen[64])
    again = traffic.ClosedLoop(DECODE, BIG, 49155).first()
    assert _key(first) == _key(again)


def test_a_request_draws_its_tokens_from_its_own_stream():
    a = traffic.tokens(9, 4, 100, 1000)
    assert (traffic.tokens(9, 4, 50, 1000) == a[:50]).all()
    assert not (traffic.tokens(9, 5, 100, 1000) == a).all()
    assert a.min() >= 0 and a.max() < 1000
