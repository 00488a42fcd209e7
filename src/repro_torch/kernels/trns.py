"""Matrix transpose on the card: `csrc/transpose.cu`.

Replaces `repro/kernels/trns.py::transpose_tiled` together with its
wrapper's padding to multiples of 128: (M, N) -> (N, M) in 32 x 32 tiles
through shared memory, edges masked in the kernel; a batch (B, M, N) ->
(B, N, M) in the same launch (PrIM TRNS's bank-local step on B banks).
The plain version is `ref.trns`; `ops.transpose` picks between them by
the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda

_P, _L = ctypes.c_void_p, ctypes.c_longlong
KERNEL = CudaKernel("transpose", "transpose", [_P, _L, _L, _L, _P, _P])
DTYPES = (torch.float32, torch.int32)    # the kernel moves 32-bit words


def transpose(A: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. A: contiguous (M, N), or (B, M, N) with
    B < 65536, f32 or int32 on a CUDA device, with fewer than 2^31 32 x 32
    tiles a matrix. Returns (N, M), or (B, N, M)."""
    check_cuda("transpose", A)
    if A.dtype not in DTYPES or A.dim() not in (2, 3):
        raise ValueError(f"transpose kernel takes 2-D or 3-D {DTYPES}, got "
                         f"{tuple(A.shape)} {A.dtype}")
    *batch, m, n = A.shape
    b = batch[0] if batch else 1
    if -(-m // 32) * -(-n // 32) >= 2 ** 31 or b >= 2 ** 16:
        raise ValueError(f"transpose: {tuple(A.shape)} has too many tiles")
    out = torch.empty(*batch, n, m, dtype=A.dtype, device=A.device)
    if A.numel():
        KERNEL.launch(A.data_ptr(), b, m, n, out.data_ptr(),
                      torch.cuda.current_stream(A.device).cuda_stream)
    return out
