"""Matrix transpose on the card: `csrc/transpose.cu`.

Replaces `repro/kernels/trns.py::transpose_tiled` together with its
wrapper's padding to multiples of 128: (M, N) -> (N, M) in 32 x 32 tiles
through shared memory, edges masked in the kernel. The plain version is
`ref.trns`; `ops.transpose` picks between them by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda

_P, _L = ctypes.c_void_p, ctypes.c_longlong
KERNEL = CudaKernel("transpose", "transpose", [_P, _L, _L, _P, _P])
DTYPES = (torch.float32, torch.int32)    # the kernel moves 32-bit words


def transpose(A: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. A: contiguous (M, N) f32 or int32 on a CUDA
    device, with fewer than 2^31 32 x 32 tiles. Returns (N, M)."""
    check_cuda("transpose", A)
    if A.dtype not in DTYPES:
        raise ValueError(f"transpose kernel takes {DTYPES}, got {A.dtype}")
    m, n = A.shape
    if -(-m // 32) * -(-n // 32) >= 2 ** 31:
        raise ValueError(f"transpose: {tuple(A.shape)} has too many tiles")
    out = torch.empty(n, m, dtype=A.dtype, device=A.device)
    if A.numel():
        KERNEL.launch(A.data_ptr(), m, n, out.data_ptr(),
                      torch.cuda.current_stream(A.device).cuda_stream)
    return out
