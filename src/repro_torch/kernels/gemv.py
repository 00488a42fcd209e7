"""Matrix-vector product on the card: `csrc/gemv.cu`.

Replaces `repro/kernels/gemv.py::gemv_tiled` together with its wrapper's
padding and cast: y = A x with f32 accumulation, returned in A's dtype.
The plain version is `ref.gemv`; `ops.gemv` picks between them by the
tensors' device. Not on the serving path: the model's projections stay
`torch.matmul`, as the reference leaves them to XLA.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("gemv", "gemv", [_P, _P, _P, _I, _I, _I, _I, _P])
DTYPE_CODE = {torch.float32: 1, torch.bfloat16: 2}


def gemv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. A: contiguous (M, K), x: contiguous (K,), each f32
    or bf16, on one CUDA device; M >= 1. Returns (M,) in A's dtype."""
    if not (A.is_cuda and x.is_cuda):
        raise ValueError("gemv kernel needs CUDA tensors")
    if A.device != x.device:
        raise ValueError("gemv: tensors on different devices")
    if not (A.is_contiguous() and x.is_contiguous()):
        raise ValueError("gemv: tensors must be contiguous")
    m, k = A.shape
    if not (1 <= m < 2 ** 31 - 64 and k < 2 ** 31):
        raise ValueError(f"gemv kernel takes 1 <= M < 2^31 - 64 and "
                         f"K < 2^31, got A {tuple(A.shape)}")
    y = torch.empty(m, dtype=A.dtype, device=A.device)
    KERNEL.launch(A.data_ptr(), x.data_ptr(), y.data_ptr(), m, k,
                  DTYPE_CODE[A.dtype], DTYPE_CODE[x.dtype],
                  torch.cuda.current_stream(A.device).cuda_stream)
    return y
