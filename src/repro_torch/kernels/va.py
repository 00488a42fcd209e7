"""Vector addition on the card: `csrc/va.cu`.

Replaces `repro/kernels/va.py::va_2d` together with its wrapper's padding
to whole tiles: the kernel takes the flat (n,) arrays and masks its own
tail. The plain version is `ref.va`; `ops.va` picks between them by the
tensors' device.

`plan` chooses the route from the pointers: "ring" (blocks streaming
contiguous ranges of whole 8 KB stages through a ring of bulk copies,
`csrc/bulk_ring.cuh`, and writing through bulk stores) when a, b and the
output are 16-byte aligned, else "stride" (the grid-stride kernel).
`KERNEL.route_launches` counts the launches of each route.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import bulk_ring
from ._build import CudaKernel, check_cuda

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("va", "va", [_P, _P, _P, _L, _I, _I, _I, _L, _L, _P])
DTYPE_CODE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
ROUTE_CODE = {"stride": 0, "ring": 1}      # route -> its code in csrc/va.cu
# kStages, kStageBytes, kConsumerWarps of csrc/va.cu
STAGES, STAGE_BYTES, CONSUMER_WARPS = 4, 8192, 8
# ranges in the grid per SM: many short ranges, so that the block scheduler
# balances the SMs' unequal shares of HBM (PERF.md, ring_sweep.py)
GRID_PER_SM = 128
STRIDE_THREADS, STRIDE_MAX_BLOCKS = 256, 132 * 16   # the stride kernel's


@dataclasses.dataclass(frozen=True)
class Plan:
    route: str
    blocks: int          # the grid
    threads: int         # a block's
    smem: int            # dynamic shared memory of a block, bytes
    units: int           # whole stages (ring), else 0
    per_block: int       # bulk_ring.block_cut of the units
    extra: int
    tail: int            # elements past the last whole stage (last block)


def plan(n: int, itemsize: int, ptrs: tuple[int, ...], sms: int,
         route: str | None = None) -> Plan:
    """The launch of `va` on n elements of `itemsize` bytes at addresses
    `ptrs` (a, b, out) on a card with `sms` SMs. `route` None chooses
    "ring" where every pointer is 16-byte aligned, else "stride"; "ring"
    asked for with unaligned pointers raises."""
    if route is None:
        route = "ring" if bulk_ring.aligned(*ptrs) else "stride"
    if route not in ROUTE_CODE:
        raise ValueError(f"va: no route {route!r}; routes {tuple(ROUTE_CODE)}")
    if route == "stride":
        vec = 16 // itemsize if bulk_ring.aligned(*ptrs) else 1
        work = -(-n // vec)
        blocks = min(max(1, -(-work // STRIDE_THREADS)), STRIDE_MAX_BLOCKS)
        return Plan(route, blocks, STRIDE_THREADS, 0, 0, 0, 0, 0)
    if not bulk_ring.aligned(*ptrs):
        raise ValueError("va: the ring route needs 16-byte aligned pointers")
    units = n // (STAGE_BYTES // itemsize)
    blocks = max(1, min(GRID_PER_SM * sms, units))
    per_block, extra = bulk_ring.block_cut(units, blocks)
    # the ring of a and b, then two store buffers of each warp's slice
    smem = bulk_ring.BARRIER_BYTES + STAGES * 2 * STAGE_BYTES + 2 * STAGE_BYTES
    return Plan(route, blocks, (CONSUMER_WARPS + 1) * 32, smem, units,
                per_block, extra, n - units * (STAGE_BYTES // itemsize))


def plan_for(a: torch.Tensor, b: torch.Tensor, out: torch.Tensor,
             route: str | None = None) -> Plan:
    return plan(a.numel(), a.element_size(),
                (a.data_ptr(), b.data_ptr(), out.data_ptr()),
                bulk_ring.sm_count(a.get_device()), route)


def va(a: torch.Tensor, b: torch.Tensor, route: str | None = None
       ) -> torch.Tensor:
    """Launch the kernel. a, b: contiguous (n,) of one dtype of
    `DTYPE_CODE` on one CUDA device. Returns a + b. `route` None lets
    `plan` choose; a route name times that route."""
    check_cuda("va", a, b)
    out = torch.empty_like(a)
    p = plan_for(a, b, out, route)
    KERNEL.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                  DTYPE_CODE[a.dtype], ROUTE_CODE[p.route], p.blocks,
                  p.per_block, p.extra,
                  torch.cuda.current_stream(a.device).cuda_stream,
                  route=p.route)
    return out
