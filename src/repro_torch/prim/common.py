"""Shared helpers for the PrIM workloads of the port.

Every workload module exposes the reference's surface (`repro.prim`):

    make_inputs(n, gen, device)  -> dict of tensors (sized for n), drawn
                                    from the torch.Generator `gen`, which
                                    lives on `device` (None: the card)
    ref(**inputs)                -> oracle result (plain torch)
    run_pim(grid, **inputs)      -> same result, bank-parallel phase
                                    structure on a `core.bank_parallel.
                                    BankGrid`
    counts(n)                    -> WorkloadCounts for the Fig-4 perf model
    SUITABLE, REF_N              -> paper Fig-4 grouping, paper-scale n

The inputs have the dtypes the reference's arrays really get: with JAX's
x64 off, every int64 of `repro.prim` is int32 and every uint64 uint32, and
every sum wraps at 2^32. The values differ from `jax.random`'s; ranges and
shapes are the reference's. Integer results are compared as the same bits
(uint32 results travel as int32).
"""

from __future__ import annotations

import torch

from ..device import resolve_device


def randint(gen: torch.Generator, lo: int, hi: int, shape, device=None,
            dtype=torch.int32) -> torch.Tensor:
    """Uniform integers in [lo, hi) of `shape` from `gen` on `device`."""
    return torch.randint(lo, hi, tuple(shape), generator=gen,
                         device=resolve_device(device), dtype=dtype)


def local_compact(vals: torch.Tensor, keep: torch.Tensor):
    """Stable compaction of `vals` where keep is True; returns
    (compacted_padded, count as a (1,) int32). Padded slots hold the
    dropped values in order (callers slice by count). Pure bank-local (a
    stable sort by ~keep)."""
    idx = torch.sort((~keep).to(torch.uint8), stable=True).indices
    return vals[idx], keep.sum(dtype=torch.int32)[None]


def assemble_compact(parts: torch.Tensor, counts: torch.Tensor,
                     total_len: int) -> torch.Tensor:
    """Host-side assembly of per-bank compacted parts (B, L) + counts (B,)
    into one dense array of `total_len`: the serial DPU->host retrieve of
    the paper. The padded slots of each part are sent to one spare slot
    past the end, which is cut off (the reference scatters them out of
    range with mode="drop", which torch has not)."""
    b, l = parts.shape
    offs = torch.cumsum(counts, 0) - counts
    pos = torch.arange(l, device=parts.device)[None, :]
    dest = torch.where(pos < counts[:, None], offs[:, None] + pos, total_len)
    out = torch.zeros(total_len + 1, dtype=parts.dtype, device=parts.device)
    out[dest.reshape(-1)] = parts.reshape(-1)
    return out[:total_len]
