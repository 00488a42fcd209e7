"""SEL — database select / stream compaction (int64 in the source, int32
as the reference runs it). Table I: sequential, add+compare,
handshake+barrier intra-DPU, inter-DPU communication.

Phases (exactly the PrIM structure):
  1. bank-local: predicate + local compaction + local count
  2. exchange:   exclusive scan of per-bank counts (through the host)
  3. host:       assembly of the compacted output at the scanned offsets
                 (the serial retrieve the paper identifies as the
                 scaling cost of SEL/UNI)

No `pallas_call` covers it: plain torch, as the reference computes it with
jnp."""

from __future__ import annotations

import torch

from ..core.bank_parallel import BANKS, BankGrid
from ..core.perf_model import WorkloadCounts
from .common import assemble_compact, local_compact, randint

SUITABLE = True
REF_N = 2**27

PRED_MOD = 2   # keep odd values (paper keeps !pred elements)


def make_inputs(n: int, gen, device=None):
    return {"x": randint(gen, 0, 1 << 30, (n,), device)}


def ref(x):
    return x[x % PRED_MOD == 1]


def run_pim(grid: BankGrid, x):
    # phase 1: bank-local compaction
    def local(xb):
        return local_compact(xb, xb % PRED_MOD == 1)
    parts, cnts = grid.local(local, out_specs=(BANKS, BANKS))(x)
    # phase 2+3: host gathers counts + parts and assembles (serial retrieve)
    total = int(torch.sum(cnts))
    return assemble_compact(grid.split(parts), cnts, total)


def counts(n: int) -> WorkloadCounts:
    kept = n / 2
    return WorkloadCounts(
        name="SEL",
        ops={("compare", "int64"): float(n), ("add", "int64"): float(n)},
        bytes_streamed=8.0 * (n + kept),
        # inter-DPU traffic is only the counts scan; the compacted result
        # rides the (parallel) final retrieve like every benchmark's output
        interbank_bytes=8.0 * 64,
        flops_equiv=float(n),
        pim_suitable=SUITABLE,
    )
