"""SCAN-RSS — prefix sum, reduce-scan-scan variant (int64 in the source,
int32 as the reference runs it). Table I: sequential, add,
handshake+barrier, inter-DPU communication.

Phases (RSS trades a second streaming pass for not re-writing the scan):
  1. bank-local reduce (totals only): the reduction kernel's int32 route
  2. exchange: exclusive scan of per-bank totals (host)
  3. bank-local full scan + offset in one pass, as the reference's: one
     launch of the single-pass scan_lookback kernel a bank, with the bank's
     offset as its carry, read on the card"""

from __future__ import annotations

import torch

from ..core.bank_parallel import BankGrid
from ..core.perf_model import WorkloadCounts
from ..kernels import ops
from .common import randint

SUITABLE = True
REF_N = 2**27


def make_inputs(n: int, gen, device=None):
    return {"x": randint(gen, -100, 100, (n,), device)}


def ref(x):
    return torch.cumsum(x, 0, dtype=torch.int32)


def run_pim(grid: BankGrid, x):
    # phase 1: local reduce
    totals = grid.local(
        lambda xb: ops.reduction(xb, acc=torch.int32)[None])(x)
    # phase 2: exclusive scan of totals (host)
    offsets = grid.exchange_scan_sums(totals)
    # phase 3: local scan + add in a single pass
    return grid.local(ops.scan_add)(x, offsets)


def counts(n: int) -> WorkloadCounts:
    return WorkloadCounts(
        name="SCAN-RSS",
        ops={("add", "int64"): 2.0 * n},    # reduce + scan
        # modelled UPMEM traffic (the reference's counts): reduce pass +
        # scan pass + write
        bytes_streamed=8.0 * 3 * n,
        interbank_bytes=8.0 * 64,
        flops_equiv=2.0 * n,
        pim_suitable=SUITABLE,
    )
