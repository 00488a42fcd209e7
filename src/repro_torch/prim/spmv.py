"""SpMV — sparse matrix-vector multiply (float32, CSR in the paper).
Table I: sequential + random access, add+mul float. Row-block partition;
x is replicated per bank (the paper copies it to every DPU's MRAM).

As in the reference, rows are padded to a fixed nnz/row (ELL layout): the
access pattern (random gathers into x) and the op mix (float mul/add) are
what the paper characterizes, and both are preserved. Plain torch, as the
reference computes it with jnp; its 16 products per row may be summed in
another order than XLA's."""

from __future__ import annotations

import torch

from ..core.bank_parallel import BANKS, BankGrid
from ..core.perf_model import WorkloadCounts
from ..device import resolve_device
from .common import randint

SUITABLE = False   # floating point (Takeaway 2)
REF_N = 2**22      # 67M nnz

NNZ_PER_ROW = 16


def make_inputs(n: int, gen, device=None):
    """n rows, NNZ_PER_ROW nonzeros each, n columns."""
    dev = resolve_device(device)
    return {"cols": randint(gen, 0, n, (n, NNZ_PER_ROW), dev),
            "vals": torch.randn(n, NNZ_PER_ROW, generator=gen, device=dev),
            "x": torch.randn(n, generator=gen, device=dev)}


def _rows(cols, vals, x):
    return torch.sum(vals * x[cols.long()], dim=-1)


def ref(cols, vals, x):
    return _rows(cols, vals, x)


def run_pim(grid: BankGrid, cols, vals, x):
    # random gathers into each bank's local copy of x
    return grid.local(_rows, in_specs=(BANKS, BANKS, None),
                      out_specs=BANKS, batched=True)(cols, vals, x)


def counts(n: int) -> WorkloadCounts:
    nnz = n * NNZ_PER_ROW
    return WorkloadCounts(
        name="SpMV",
        ops={("mul", "float"): float(nnz), ("add", "float"): float(nnz)},
        bytes_streamed=8.0 * nnz + 4.0 * 2 * n,   # val+col per nnz, x + y
        interbank_bytes=0.0,
        flops_equiv=2.0 * nnz,
        pim_suitable=SUITABLE,
        bytes_cpu=8.0 * nnz + 64.0 * nnz + 4.0 * 2 * n,  # line per gather
        bytes_gpu=8.0 * nnz + 16.0 * nnz + 4.0 * 2 * n,  # sector per gather
    )
