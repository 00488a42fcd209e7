"""Launch plans of the kernels built on `csrc/bulk_ring.cuh` (va, gemv).

Those kernels run a persistent grid: a few blocks per SM, each streaming a
contiguous range of work units (whole stages of a vector, rows of a matrix)
through a ring of shared-memory stages filled by bulk copies. The cut of
the units over the blocks is computed here, from shapes alone, and passed
to the kernel, which reads its range with `bulk_ring::block_range`.
"""

from __future__ import annotations

import functools

import torch

SMEM_MAX = 232448      # bulk_ring::kMaxSmem: an H100 block's opt-in maximum
BARRIER_BYTES = 128    # bulk_ring::kBarrierBytes: the ring's barriers
ALIGN = 16             # bulk copies move 16-byte multiples between 16-byte
#                        aligned addresses


def block_cut(units: int, blocks: int) -> tuple[int, int]:
    """(per_block, extra): every block takes `per_block` units and the first
    `extra` blocks one more, so shares differ by at most one unit."""
    if units < 0 or blocks < 1:
        raise ValueError(f"block_cut: want units >= 0 and blocks >= 1, got "
                         f"{units}, {blocks}")
    return divmod(units, blocks)


def block_range(b: int, per_block: int, extra: int) -> tuple[int, int]:
    """(first unit, count) of block `b`: what `bulk_ring::block_range`
    computes on the card."""
    return b * per_block + min(b, extra), per_block + (b < extra)


def aligned(*ptrs: int) -> bool:
    """Every address a multiple of ALIGN."""
    return all(p % ALIGN == 0 for p in ptrs)


@functools.lru_cache(maxsize=None)
def sm_count(device: int) -> int:
    """The SM count of CUDA device number `device`, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count
