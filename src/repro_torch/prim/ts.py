"""TS — time series analysis (int32). Table I: sequential, add/sub/mul/div.

PrIM's TS computes a matrix-profile-style distance of a query subsequence
against every window of a long series. The series is sharded across banks
with an (m-1)-element halo from the RIGHT neighbor so every window is
computable bank-locally; the final min-distance/argmin is a tiny
cross-bank reduction.

Port: the bank-local phase is one launch of the ts kernel a bank
(`kernels.ops.ts_min`: f32 distances, exact here since the largest is
8 * 199^2 = 316,808 < 2^24, and the first argmin). Only windows that end
inside the series are scored: the reference's `run_pim` also scores the
m - 1 windows of the last bank that run into its zero halo (a fault of the
reference); `ref` does not, and neither does this."""

from __future__ import annotations

import torch

from ..core.bank_parallel import BANKS, BankGrid
from ..core.perf_model import WorkloadCounts
from ..kernels import ops
from .common import randint

SUITABLE = False    # mul/div heavy (Takeaway 2)
REF_N = 2**26

M = 8  # query length
NONE = torch.iinfo(torch.int32).max     # a bank with no window of its own


def make_inputs(n: int, gen, device=None):
    return {"series": randint(gen, -100, 100, (n,), device),
            "query": randint(gen, -100, 100, (M,), device)}


def ref(series, query):
    """(min squared distance, first window reaching it), int32 each, the
    distances summed in int32 as the reference does (x64 off): one
    contraction over the (windows, m) view of the series, as the
    reference's `sum(d * d, axis=1)` over its gathered windows."""
    d = series.unfold(0, query.numel(), 1) - query
    dists = (d * d).sum(1, dtype=torch.int32)
    return dists.min(), torch.argmin(dists).to(torch.int32)


def run_pim(grid: BankGrid, series, query):
    b = grid.n_banks
    n, m = series.numel(), query.numel()
    per = n // b
    if per < m - 1:
        raise ValueError(f"TS: a bank's {per} elements cannot hold the "
                         f"{m - 1}-element halo")
    nwin = n - m + 1

    # phase 1 (exchange): halo — first m-1 elements of the RIGHT neighbor
    heads = grid.local(lambda xb: xb[:m - 1])(series)
    halo = grid.exchange_shift(heads, offset=-1)  # bank i gets bank i+1's

    # phase 2: bank-local windows (+ halo) that end inside the series,
    # local min/argmin
    def local(xb, hb, qb, bank):
        own = min(per, nwin - bank * per)      # windows this bank scores
        if own <= 0:
            return (torch.full((1,), NONE, dtype=torch.int32,
                               device=xb.device),
                    torch.full((1,), bank * per, dtype=torch.int32,
                               device=xb.device))
        seg = xb if own + m - 1 <= per else torch.cat([xb, hb])
        d, i = ops.ts_min(seg[:own + m - 1], qb)
        return d.to(torch.int32)[None], (i + bank * per)[None]
    dmin, amin = grid.local(
        local, in_specs=(BANKS, BANKS, None, BANKS),
        out_specs=(BANKS, BANKS))(series, halo, query, grid.bank_ids())

    # phase 3 (exchange): global min + owner (host-side tiny reduce); the
    # first bank with the minimum holds its first window
    best = torch.argmin(dmin)
    return dmin[best], amin[best]


def counts(n: int) -> WorkloadCounts:
    return WorkloadCounts(
        name="TS",
        ops={("sub", "int32"): float(n * M), ("mul", "int32"): float(n * M),
             ("add", "int32"): float(n * M), ("div", "int32"): float(n)},
        bytes_streamed=4.0 * n * M,
        interbank_bytes=0.0,
        flops_equiv=3.0 * n * M,
        pim_suitable=SUITABLE,
    )
