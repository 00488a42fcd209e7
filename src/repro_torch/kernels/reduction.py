"""Sum of an array on the card: `csrc/reduction.cu`.

Replaces `repro/kernels/reduction.py::reduce_2d` together with its
wrapper's padding. Two passes (per-block partials, then one block over the
partials in a fixed order), no atomics: two launches on the same data give
the same bits. Two routes: "f32" sums any dtype of `DTYPE_CODE` into an
f32 (the Pallas kernel's contract); "int32" sums int32 into an int32 that
wraps at 2^32, what PrIM RED computes (`repro/prim/red.py` with x64 off).
`KERNEL.route_launches` counts the launches of each. The plain version is
`ref.reduction`; `ops.reduction` picks between them by the tensor's
device.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("reduction", "reduction", [_P, _L, _I, _I, _P, _P, _P])
DTYPE_CODE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
ACC_CODE = {torch.float32: 0, torch.int32: 1}   # the routes, by accumulator
MAX_BLOCKS = 1024     # kMaxBlocks in csrc/reduction.cu: partials per launch


def reduction(x: torch.Tensor, acc: torch.dtype = torch.float32
              ) -> torch.Tensor:
    """Launch the kernel. x: contiguous (n,) of one dtype of `DTYPE_CODE`
    on a CUDA device; acc: f32, or int32 for int32 x. Returns a 0-dim
    tensor of `acc` on that device (no host sync)."""
    check_cuda("reduction", x)
    if acc not in ACC_CODE or (acc == torch.int32 and x.dtype != torch.int32):
        raise ValueError(f"reduction kernel: acc must be f32, or int32 for "
                         f"int32 x; got acc {acc}, x {x.dtype}")
    partials = torch.empty(MAX_BLOCKS, dtype=acc, device=x.device)
    out = torch.empty((), dtype=acc, device=x.device)
    KERNEL.launch(x.data_ptr(), x.numel(), DTYPE_CODE[x.dtype],
                  ACC_CODE[acc], partials.data_ptr(), out.data_ptr(),
                  torch.cuda.current_stream(x.device).cuda_stream,
                  route="int32" if acc == torch.int32 else "f32")
    return out
