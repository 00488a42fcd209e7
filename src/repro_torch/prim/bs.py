"""BS — binary search (data analytics; int64 in the source, int32 as the
reference runs it). Table I: sequential + random access, compare only, no
sync. Queries are sharded across banks; the sorted array is replicated to
each bank's MRAM (the PrIM layout). Plain torch (`searchsorted`), as the
reference computes it with jnp."""

from __future__ import annotations

import math

import torch

from ..core.bank_parallel import BANKS, BankGrid
from ..core.perf_model import WorkloadCounts
from .common import randint

SUITABLE = True
REF_N = 2**21      # 2M queries into a 16 MB sorted array


def make_inputs(n: int, gen, device=None):
    """n queries against a sorted array of n elements."""
    arr = torch.sort(randint(gen, 0, 1 << 30, (n,), device)).values
    return {"arr": arr, "queries": randint(gen, 0, 1 << 30, (n,), device)}


def ref(arr, queries):
    return torch.searchsorted(arr, queries).to(torch.int32)


def run_pim(grid: BankGrid, arr, queries):
    def local(a, q):
        return torch.searchsorted(a, q).to(torch.int32)
    return grid.local(local, in_specs=(None, BANKS), out_specs=BANKS,
                      batched=True)(arr, queries)


def counts(n: int) -> WorkloadCounts:
    steps = max(math.log2(n), 1.0)
    return WorkloadCounts(
        name="BS",
        ops={("compare", "int64"): float(n * steps)},
        bytes_streamed=8.0 * (n * steps + n),   # random probes + queries
        interbank_bytes=0.0,
        flops_equiv=float(n * steps),
        pim_suitable=SUITABLE,
        # CPU probes are dependent 64B-line misses once below the cached
        # tree top (~half the levels); GPU fetches 32B sectors
        bytes_cpu=8.0 * n + 32.0 * n * steps,
        bytes_gpu=8.0 * n + 16.0 * n * steps,
    )
