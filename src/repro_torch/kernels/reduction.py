"""Sum of an array on the card: `csrc/reduction.cu`.

Replaces `repro/kernels/reduction.py::reduce_2d` together with its
wrapper's padding. Two passes (per-block f32 partials, then one block over
the partials in a fixed order), no atomics: two launches on the same data
give the same bits. The plain version is `ref.reduction`; `ops.reduction`
picks between them by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("reduction", "reduction", [_P, _L, _I, _P, _P, _P])
DTYPE_CODE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}
MAX_BLOCKS = 1024     # kMaxBlocks in csrc/reduction.cu: partials per launch


def reduction(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. x: contiguous (n,) of one dtype of `DTYPE_CODE`
    on a CUDA device. Returns a 0-dim f32 tensor on that device (no host
    sync)."""
    check_cuda("reduction", x)
    partials = torch.empty(MAX_BLOCKS, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    KERNEL.launch(x.data_ptr(), x.numel(), DTYPE_CODE[x.dtype],
                  partials.data_ptr(), out.data_ptr(),
                  torch.cuda.current_stream(x.device).cuda_stream)
    return out
