"""The one traffic generator: requests drawn from a cell's mix parameters
and `--seed`.

Every seed gets the same multiset of sizes, in another order. Lengths
are the mix's quantiles at the midpoints of N equal strata (log-uniform
prompts, uniform outputs); the seed permutes them and draws the token
ids. So two seeds differ in which request comes when and with which
tokens, not in how much work the window holds.

Open loop (`"loop": "open"`): `round(rate_rps * seconds)` requests due
from 0 on, their gaps the exponential's quantiles at the same midpoints
in one fixed order, the same for every seed: one Poisson schedule, so
that a seed does not change the bursts (at 0.6 of the knee the tails
moved 10-25% with the bursts of the seed's order, PERF.md).

Closed loop (`"loop": "closed"`): a pool of requests that the clients
take in turn; for the steady state each client's first request is in
progress, its prompt extended by a share of its output (the shares are
strata of [0, 1) too) and its budget what is left.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# pool size of a closed loop, in requests per client: more than a window
# of the longest run can take
POOL_PER_CLIENT = 16


@dataclasses.dataclass
class Spec:
    """One request as the mix makes it: `prompt` token ids (the extension
    of a request in progress included), `budget` new tokens, `due` seconds
    after the window opens (open loop; None in a closed loop), `client`
    (closed loop), `prefilled` = len(prompt)."""
    rid: int
    prompt: np.ndarray
    budget: int
    due: float | None = None
    client: int | None = None

    @property
    def prefilled(self) -> int:
        return int(self.prompt.shape[0])


def strata(n: int) -> np.ndarray:
    """Midpoints of n equal strata of [0, 1)."""
    return (np.arange(n) + 0.5) / n


def lengths(dist: dict, u: np.ndarray) -> np.ndarray:
    """Integer lengths at quantiles `u` of `dist`: {"dist": "loguniform"
    or "uniform", "lo": ..., "hi": ...}, both ends included."""
    lo, hi = int(dist["lo"]), int(dist["hi"])
    if dist["dist"] == "loguniform":
        x = np.exp(math.log(lo) + u * (math.log(hi + 1) - math.log(lo)))
    elif dist["dist"] == "uniform":
        x = lo + u * (hi + 1 - lo)
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.floor(x).astype(np.int64), lo, hi)


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64([int(seed), *stream]))


def tokens(seed: int, rid: int, n: int, vocab: int) -> np.ndarray:
    """The `n` token ids of request `rid`: uniform over the vocabulary,
    from their own stream, so a request's prompt does not depend on the
    order the requests are taken in."""
    return _rng(seed, 1, rid).integers(0, vocab, n, dtype=np.int64)


def open_loop(mix: dict, seed: int, seconds: float, vocab: int) -> list[Spec]:
    """The requests due in a window of `seconds`: Poisson arrivals at
    `rate_rps`, by stratified gaps in a fixed order."""
    n = max(1, round(float(mix["rate_rps"]) * seconds))
    gaps = -np.log1p(-strata(n)) / float(mix["rate_rps"])
    gaps = _rng(0, 3).permutation(gaps)
    rng = _rng(seed, 0)
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    plen = rng.permutation(lengths(mix["prompt_tokens"], strata(n)))
    olen = rng.permutation(lengths(mix["output_tokens"], strata(n)))
    return [Spec(i, tokens(seed, i, int(plen[i]), vocab), int(olen[i]),
                 due=float(due[i])) for i in range(n)]


class ClosedLoop:
    """The request pool of a closed loop: `first()` gives each client's
    request in progress, `next(client)` the client's next request."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.seed, self.vocab = mix, seed, vocab
        self.clients = int(mix["clients"])
        n = self.clients * POOL_PER_CLIENT
        rng = _rng(seed, 0)
        self.plen = rng.permutation(lengths(mix["prompt_tokens"], strata(n)))
        self.olen = rng.permutation(lengths(mix["output_tokens"], strata(n)))
        self.share = rng.permutation(strata(self.clients))
        self.taken = 0

    def _spec(self, client: int, extend: float = 0.0) -> Spec:
        i = self.taken
        if i >= self.plen.shape[0]:
            raise RuntimeError("closed-loop request pool exhausted")
        self.taken += 1
        plen, olen = int(self.plen[i]), int(self.olen[i])
        ext = min(int(extend * olen), olen - 1)
        return Spec(i, tokens(self.seed, i, plen + ext, self.vocab),
                    olen - ext, client=client)

    def first(self) -> list[Spec]:
        """One request in progress per client: prompt plus a stratified
        share of its output already in the cache, the rest its budget."""
        return [self._spec(c, float(self.share[c]))
                for c in range(self.clients)]

    def next(self, client: int) -> Spec:
        return self._spec(client)
