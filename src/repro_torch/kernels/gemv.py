"""Matrix-vector product on the card: `csrc/gemv.cu`.

Replaces `repro/kernels/gemv.py::gemv_tiled` together with its wrapper's
padding and cast: y = A x with f32 accumulation, returned in A's dtype
(the "f32" route), or, for int32 A and x, with every multiply and add
wrapping at 2^32 into int32 (the "int32" route: PrIM GEMV's uint32 bits
and MLP's int32, as the reference computes them with x64 off).
The plain version is `ref.gemv`; `ops.gemv` picks between them by the
tensors' device. Not on the serving path: the model's projections stay
`torch.matmul`, as the reference leaves them to XLA.

`plan` chooses the route: "ring" (a persistent grid, one block per SM
streaming its contiguous rows through a ring of bulk copies,
`csrc/bulk_ring.cuh`)
where A is 16-byte aligned, K * size is a multiple of 16 and x fits in
shared memory as f32 beside the ring, else "rows" (the 32-rows-a-block
kernel). `KERNEL.route_launches` counts the launches by accumulator and
route ("f32/ring", "int32/rows", ...).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import bulk_ring
from ._build import CudaKernel, check_cuda

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("gemv", "gemv", [_P, _P, _P] + [_I] * 6 + [_L, _L, _I, _P])
DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}   # the f32 route's
INT32_CODE = 0                                       # A and x, int32 route
ROUTE_CODE = {"rows": 0, "ring": 1}
# kRingStages, kRingWarps of csrc/gemv.cu; a stage holds a row for each warp
STAGES, RING_WARPS = 4, 4
# bytes of A a stage holds at most: 16 KB stages start the stream sooner
# than 32 KB ones (PERF.md, ring_sweep.py)
STAGE_CAP = 16384
BLOCKS_PER_SM = 1
ROWS_THREADS, ROWS_PER_BLOCK = 256, 32   # the rows kernel's
# the largest K whose x, as f32, fits beside a ring of full stages
MAX_RING_K = (bulk_ring.SMEM_MAX - bulk_ring.BARRIER_BYTES
              - STAGES * STAGE_CAP) // 4


@dataclasses.dataclass(frozen=True)
class Plan:
    route: str
    blocks: int          # the grid
    threads: int         # a block's
    smem: int            # dynamic shared memory of a block, bytes
    per_block: int       # bulk_ring.block_cut of the M rows (ring)
    extra: int
    kc: int              # columns of A a stage holds (ring), else 0
    stage_bytes: int     # bytes of A a full stage holds (ring), else 0


def ring_kc(k: int, itemsize: int) -> int:
    """Columns a ring stage holds: all K where RING_WARPS rows fit in
    STAGE_CAP, else the most that fit, in 16-byte multiples."""
    vec = 16 // itemsize
    return min(k, STAGE_CAP // (RING_WARPS * itemsize) // vec * vec)


def ring_smem(k: int, itemsize: int) -> int:
    return (bulk_ring.BARRIER_BYTES
            + STAGES * RING_WARPS * ring_kc(k, itemsize) * itemsize + 4 * k)


def plan(m: int, k: int, itemsize: int, a_ptr: int, sms: int,
         route: str | None = None) -> Plan:
    """The launch of `gemv` on A (m, k) of `itemsize` bytes at address
    `a_ptr` on a card with `sms` SMs. `route` None chooses "ring" where A
    is 16-byte aligned, k >= 1, k * itemsize is a multiple of 16 and x fits
    beside the ring, else "rows"; "ring" asked for where it cannot run
    raises."""
    fits = (k >= 1 and k * itemsize % bulk_ring.ALIGN == 0
            and bulk_ring.aligned(a_ptr)
            and ring_smem(k, itemsize) <= bulk_ring.SMEM_MAX)
    if route is None:
        route = "ring" if fits else "rows"
    if route not in ROUTE_CODE:
        raise ValueError(f"gemv: no route {route!r}; routes "
                         f"{tuple(ROUTE_CODE)}")
    if route == "rows":
        return Plan(route, -(-m // ROWS_PER_BLOCK), ROWS_THREADS, 0, 0, 0,
                    0, 0)
    if not fits:
        raise ValueError(f"gemv: the ring route needs A 16-byte aligned, "
                         f"K * size a multiple of 16 and K <= "
                         f"{MAX_RING_K}; got A ({m}, {k}) of "
                         f"{itemsize}-byte elements at {a_ptr:#x}")
    blocks = max(1, min(BLOCKS_PER_SM * sms, m))
    per_block, extra = bulk_ring.block_cut(m, blocks)
    kc = ring_kc(k, itemsize)
    return Plan(route, blocks, (RING_WARPS + 1) * 32, ring_smem(k, itemsize),
                per_block, extra, kc, RING_WARPS * kc * itemsize)


def plan_for(A: torch.Tensor, route: str | None = None) -> Plan:
    m, k = A.shape
    return plan(m, k, A.element_size(), A.data_ptr(),
                bulk_ring.sm_count(A.get_device()), route)


def gemv(A: torch.Tensor, x: torch.Tensor, route: str | None = None
         ) -> torch.Tensor:
    """Launch the kernel. A: contiguous (M, K), x: contiguous (K,), each f32
    or bf16, or both int32 (the int32 route), on one CUDA device; M >= 1.
    Returns (M,) in A's dtype. `route` None lets `plan` choose; a route
    name times that route."""
    check_cuda("gemv", A, x)
    exact = A.dtype == torch.int32
    if exact != (x.dtype == torch.int32) or not exact and (
            A.dtype not in DTYPE_CODE or x.dtype not in DTYPE_CODE):
        raise ValueError(f"gemv kernel takes A and x of {tuple(DTYPE_CODE)}, "
                         f"or both int32; got {A.dtype}, {x.dtype}")
    codes = ((INT32_CODE, INT32_CODE) if exact
             else (DTYPE_CODE[A.dtype], DTYPE_CODE[x.dtype]))
    m, k = A.shape
    if not (1 <= m < 2 ** 31 - 64 and k < 2 ** 31):
        raise ValueError(f"gemv kernel takes 1 <= M < 2^31 - 64 and "
                         f"K < 2^31, got A {tuple(A.shape)}")
    p = plan_for(A, route)
    y = torch.empty(m, dtype=A.dtype, device=A.device)
    KERNEL.launch(A.data_ptr(), x.data_ptr(), y.data_ptr(), m, k, *codes,
                  ROUTE_CODE[p.route], p.blocks, p.per_block, p.extra, p.kc,
                  torch.cuda.current_stream(A.device).cuda_stream,
                  route=f"{'int32' if exact else 'f32'}/{p.route}")
    return y
