"""TRNS — matrix transposition (int64 in the source, int32 as the
reference runs it). Table I: sequential + random, add/sub/mul (index
arithmetic), mutex, NO inter-DPU column.

The PrIM algorithm: the host performs the coarse (tile-granular) transpose
as part of the scatter to MRAM banks; each DPU then transposes its own
tiles in-place (step 2/3 of the paper's algorithm). The reference runs its
all-to-all inside its local phase; the port makes it what it is, an
exchange of the grid (the host coarse step: bank j receives every bank's
j-th column tile), followed by one batched launch of the transpose kernel
over every bank's received tile (the DPU fine step)."""

from __future__ import annotations

from ..core.bank_parallel import BankGrid
from ..core.perf_model import WorkloadCounts
from ..kernels import ops
from .common import randint

SUITABLE = True
REF_N = 2**13      # 8192 x 8192


def make_inputs(n: int, gen, device=None):
    """(n, n) int32 matrix."""
    return {"A": randint(gen, -1000, 1000, (n, n), device)}


def ref(A):
    return A.t().contiguous()


def run_pim(grid: BankGrid, A):
    # exchange: bank j receives the j-th column tile of every bank's rows,
    # stacked in bank order: (m, n / b), the whole column tile
    recv = grid.exchange_all_to_all(A, split_axis=1)
    # local: transpose each bank's column tile -> its n / b output rows
    return grid.local(ops.transpose, batched=True)(recv)


def counts(n: int) -> WorkloadCounts:
    elems = float(n * n)
    return WorkloadCounts(
        name="TRNS",
        ops={("add", "int64"): elems / 8, ("sub", "int64"): elems / 16,
             ("mul", "int64"): elems / 16},   # amortized index arithmetic
        bytes_streamed=8.0 * 2 * elems,
        interbank_bytes=0.0,    # coarse step rides the initial host scatter
        flops_equiv=elems / 4,
        pim_suitable=SUITABLE,
        bytes_cpu=(8.0 + 64.0) * elems,   # strided writes: line per element
        # GPU tiles through shared memory: no penalty
    )
