"""SCAN-SSA — prefix sum, scan-scan-add variant (int64 in the source, int32
as the reference runs it). Table I: sequential, add, handshake+barrier,
inter-DPU communication.

Phases (the PrIM SSA structure):
  1. bank-local inclusive scan of the bank's block: one launch of the
     single-pass scan_lookback kernel a bank; the bank total is the scan's
     last element
  2. exchange: exclusive scan of the per-bank totals (through the host)
  3. bank-local add of the incoming offset: one launch of add_offsets's
     int32 route a bank, the bank's offset on every tile"""

from __future__ import annotations

import torch

from ..core.bank_parallel import BANKS, BankGrid
from ..core.perf_model import WorkloadCounts
from ..kernels import ops
from ..kernels.ref import SCAN_TILE
from .common import randint

SUITABLE = True
REF_N = 2**27


def make_inputs(n: int, gen, device=None):
    return {"x": randint(gen, -100, 100, (n,), device)}


def ref(x):
    return torch.cumsum(x, 0, dtype=torch.int32)


def run_pim(grid: BankGrid, x):
    # phase 1: local inclusive scan (+ the bank total)
    def local_scan(xb):
        s = ops.scan(xb, acc=torch.int32)
        return s, s[-1:]
    scanned, totals = grid.local(local_scan, out_specs=(BANKS,) * 2)(x)
    # phase 2: exclusive scan of bank totals (host)
    offsets = grid.exchange_scan_sums(totals)
    # phase 3: local add, the bank's offset on each of its tiles
    def local_add(sb, ob):
        tiles = -(-sb.numel() // SCAN_TILE)
        return ops.add_offsets(sb, ob.expand(tiles).contiguous(),
                               torch.int32)
    return grid.local(local_add)(scanned, offsets)


def counts(n: int) -> WorkloadCounts:
    return WorkloadCounts(
        name="SCAN-SSA",
        ops={("add", "int64"): 2.0 * n},    # scan + offset add
        # modelled UPMEM traffic (the reference's counts): read, write
        # scan, rewrite add
        bytes_streamed=8.0 * 3 * n,
        interbank_bytes=8.0 * 64,
        flops_equiv=2.0 * n,
        pim_suitable=SUITABLE,
    )
