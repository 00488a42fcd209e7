"""Plan cache: planner products keyed by batch signature.

A copy of `repro.dispatch.plan_cache`, kept in the port because the port
imports nothing of `repro`; it uses no framework.

`FaceCache` (executor.py) amortizes stage *compiles* across executors;
this module extends the same sharing idiom one level up, to planner
*plans*: planning a DAG costs a frontier-DP / branch-and-bound solve per
call (milliseconds of host work, growing with graph size), while a
serving batch's composition churns every admission and eviction — the
live-slot count grows and shrinks, per-slot positions advance every
step, and ragged prompts split into different chunk grids.
`batch_signature` canonicalizes that churn into a coarse key (live-slot
count, bucketed position, chunk splits, channel-topology shape) so
equal-shaped compositions
share one solve, and `PlanCache` LRU-holds whatever the solve produced
(a `Plan`, a priced (graph, plan, seconds) bundle, a `PlanExecutor`)
with FaceCache-style hit/miss accounting.

Users: the serving gateway (`repro_torch.serve.gateway`) prices every decode
step and every candidate admission through one of these, and
`serve.dispatch_engine.DispatchPrefillStep` holds its per-chunk-split
executors in one. Modeled times stored by builders are SECONDS; keys
are plain tuples.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Hashable, Iterable, Sequence


def batch_signature(n_live: int, positions: Iterable[int] = (), *,
                    pos_bucket: int = 64, splits: Sequence[int] = (),
                    phase: str = "decode", topology: Any = (),
                    window: int = 0) -> tuple:
    """Canonical plan-cache key for one batch composition:
    `(phase, live-slot count, bucketed KV length, chunk splits,
    topology shape[, window])`.

    The KV length is the max position rounded UP to a multiple of
    `pos_bucket` (the sequence length the priced DAG assumes —
    conservative: the model never underestimates resident KV), so a slot
    advancing within a bucket is a cache hit and only bucket crossings
    replan. `splits` carries the chunked-prefill grid
    (`workloads.prefill_chunk_splits`); leave it empty for decode.
    `topology` carries the channel-topology shape the priced plan
    assumes — a `placement.Topology` (its `.signature`, `(base,
    n_ranks)`) or an already-hashable shape tuple — so plans priced
    under different rank counts never alias; the empty default means
    the single-channel topology. `window` is the sliding-window bound
    the priced DAG assumes (`DecodeDims.window`; 0 = full attention):
    a windowed and a full-attention batch with identical
    `(n_live, positions, splits)` price DIFFERENT graphs (ring-width
    KV, banded prefill) and must never serve each other's plan. The
    zero default appends nothing, keeping every pre-window signature
    byte-identical."""
    if pos_bucket < 1:
        raise ValueError(f"pos_bucket must be >= 1, got {pos_bucket}")
    mx = max((int(p) for p in positions), default=0)
    kv_len = (mx // pos_bucket + 1) * pos_bucket
    topo = getattr(topology, "signature", topology)
    sig = (str(phase), int(n_live), int(kv_len),
           tuple(int(s) for s in splits), tuple(topo))
    return sig + (int(window),) if window else sig


class PlanCache:
    """LRU cache of planner products keyed by batch signature.

    `get_or_plan(key, builder)` is the whole interface: a hit returns
    the cached value and a miss runs `builder()` once (the amortized
    planner solve), evicting the stalest entry beyond `maxsize`. The
    cache accounts for itself like `FaceCache` does — `stats` exposes
    calls/hits/misses/evictions and the hit rate the gateway bench
    gates (>80% at steady state under batch-composition churn)."""

    def __init__(self, maxsize: int = 64):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = maxsize
        self._entries: "collections.OrderedDict[Hashable, Any]" = \
            collections.OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def get_or_plan(self, key: Hashable, builder: Callable[[], Any]) -> Any:
        """Return the entry cached under `key`, calling `builder()` to
        create it on a miss; LRU-evicts beyond `maxsize`. The entry is
        whatever `builder` returns — a `Plan`, a priced bundle with its
        modeled seconds, a `PlanExecutor` — the cache never inspects
        it."""
        if key in self._entries:
            self._hits += 1
            self._entries.move_to_end(key)
            return self._entries[key]
        self._misses += 1
        value = builder()
        while len(self._entries) >= self.maxsize:
            self._entries.popitem(last=False)
            self._evictions += 1
        self._entries[key] = value
        return value

    def __len__(self) -> int:
        """Number of cached entries (<= maxsize)."""
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        """True when `key` is cached (no stats bump, no LRU touch)."""
        return key in self._entries

    @property
    def stats(self) -> dict:
        """FaceCache-style accounting: `{"calls", "hits", "misses",
        "evictions", "size", "hit_rate"}`. `hit_rate` is hits/calls
        (0.0 before the first call) — the steady-state quantity the
        gateway bench's churn sweep gates."""
        calls = self._hits + self._misses
        return {"calls": calls, "hits": self._hits,
                "misses": self._misses, "evictions": self._evictions,
                "size": len(self._entries),
                "hit_rate": (self._hits / calls) if calls else 0.0}
