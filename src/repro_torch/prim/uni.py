"""UNI — database unique (remove consecutive duplicates; int64 in the
source, int32 as the reference runs it). Table I: sequential,
add+compare, handshake+barrier, inter-DPU communication.

Like SEL plus one extra exchange: bank i needs bank i-1's LAST element to
decide whether its own first element is a duplicate (neighbor handshake).
Plain torch, as the reference computes it with jnp."""

from __future__ import annotations

import torch

from ..core.bank_parallel import BANKS, BankGrid
from ..core.perf_model import WorkloadCounts
from .common import assemble_compact, local_compact, randint

SUITABLE = True
REF_N = 2**27


def make_inputs(n: int, gen, device=None):
    # runs of duplicates: sorted small-alphabet values
    x = randint(gen, 0, max(n // 4, 4), (n,), device)
    return {"x": torch.sort(x).values}


def ref(x):
    keep = torch.ones_like(x, dtype=torch.bool)
    keep[1:] = x[1:] != x[:-1]
    return x[keep]


def run_pim(grid: BankGrid, x):
    # phase 1 (exchange): neighbor handshake — last element of bank i-1
    lasts = grid.local(lambda xb: xb[-1:])(x)
    prev_last = grid.exchange_shift(lasts, offset=1)

    # phase 2: bank-local predicate + compaction; bank 0's first element
    # is always kept (no predecessor)
    def local(xb, prevb, bank):
        keep = xb != torch.cat([prevb, xb[:-1]])
        if bank == 0:
            keep[0] = True
        return local_compact(xb, keep)
    parts, cnts = grid.local(
        local, in_specs=(BANKS, BANKS, BANKS),
        out_specs=(BANKS, BANKS))(x, prev_last, grid.bank_ids())

    # phase 3: host-side assembly
    total = int(torch.sum(cnts))
    return assemble_compact(grid.split(parts), cnts, total)


def counts(n: int) -> WorkloadCounts:
    kept = n / 4
    return WorkloadCounts(
        name="UNI",
        ops={("compare", "int64"): float(n), ("add", "int64"): float(n)},
        bytes_streamed=8.0 * (n + kept),
        interbank_bytes=8.0 * 64,   # neighbor handshake + counts scan
        flops_equiv=float(n),
        pim_suitable=SUITABLE,
    )
