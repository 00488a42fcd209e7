"""SCAN-SSA — prefix sum, scan-scan-add variant (int64 in the source, int32
as the reference runs it). Table I: sequential, add, handshake+barrier,
inter-DPU communication.

Phases (the PrIM SSA structure):
  1. bank-local inclusive scan of the bank's block: one launch of the
     scan_blocks kernel's int32 route (each 8192-element tile scanned, with
     its total), the fixed-order scan of the tile totals, the bank total
  2. exchange: exclusive scan of the per-bank totals (through the host)
  3. bank-local add of the incoming offset: one launch of add_offsets
     (each tile's offset within the bank plus the bank's offset)"""

from __future__ import annotations

import torch

from ..core.bank_parallel import BANKS, BankGrid
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
    # phase 1: local inclusive scan per tile (+ the tiles' offsets within
    # the bank and the bank total)
    def local_scan(xb):
        scans, totals = ops.scan_blocks(xb, acc=torch.int32)
        offs = ops.tile_offsets(totals)
        return scans, offs, offs[-1:] + totals[-1:]
    scanned, offs, totals = grid.local(
        local_scan, out_specs=(BANKS,) * 3)(x)
    # phase 2: exclusive scan of bank totals (host)
    offsets = grid.exchange_scan_sums(totals)
    # phase 3: local add
    def local_add(sb, tb, ob):
        return ops.add_offsets(sb, tb + ob, torch.int32)
    return grid.local(local_add)(scanned, offs, offsets)


def counts(n: int) -> WorkloadCounts:
    return WorkloadCounts(
        name="SCAN-SSA",
        ops={("add", "int64"): 2.0 * n},    # scan + offset add
        bytes_streamed=8.0 * 3 * n,          # read, write scan, rewrite add
        interbank_bytes=8.0 * 64,
        flops_equiv=2.0 * n,
        pim_suitable=SUITABLE,
    )
