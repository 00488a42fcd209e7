"""GEMV — matrix-vector multiply (dense linear algebra). Table I:
sequential, add+mul, uint32. Row-block partitioning: each bank owns M/B
rows of A and the whole x (the UPMEM layout); y is produced bank-locally
and retrieved by the host. No inter-DPU communication.

Port: the uint32 data travels as int32 bits (wrapping multiply-add gives
the same bits signed or unsigned); the bank-local phase is one launch of
the gemv kernel's int32 route over every bank's rows."""

from __future__ import annotations

import torch

from ..core.bank_parallel import BANKS, BankGrid
from ..core.perf_model import WorkloadCounts
from ..kernels import ops
from .common import randint

SUITABLE = False   # uses multiplication (Takeaway 2)
REF_N = 2**13      # 8192 x 2048


def make_inputs(n: int, gen, device=None):
    """n = M; N fixed at n//4 for a 4:1 aspect (paper uses 8192x1024).
    uint32 values < 64, as their int32 bits."""
    m, k = n, max(n // 4, 8)
    return {"A": randint(gen, 0, 64, (m, k), device),
            "x": randint(gen, 0, 64, (k,), device)}


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def ref(A, x):
    """A x with uint32 wrapping, as int32 bits: an int64 multiply-and-sum
    cut to 32 bits."""
    A, x = _bits(A), _bits(x)
    return ((A.long() * x.long()).sum(1)).to(torch.int32)


def run_pim(grid: BankGrid, A, x):
    A, x = _bits(A), _bits(x)
    k = A.shape[1]

    def local(Ab, xb):
        return ops.gemv(Ab.reshape(-1, k), xb, acc=torch.int32) \
            .view(Ab.shape[:2])
    return grid.local(local, in_specs=(BANKS, None), out_specs=BANKS,
                      batched=True)(A, x)


def counts(n: int) -> WorkloadCounts:
    m, k = n, max(n // 4, 8)
    return WorkloadCounts(
        name="GEMV",
        ops={("mul", "int32"): float(m * k), ("add", "int32"): float(m * k)},
        bytes_streamed=4.0 * (m * k + k + m),
        interbank_bytes=0.0,
        flops_equiv=2.0 * m * k,
        pim_suitable=SUITABLE,
    )
