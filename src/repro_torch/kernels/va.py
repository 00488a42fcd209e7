"""Vector addition on the card: `csrc/va.cu`.

Replaces `repro/kernels/va.py::va_2d` together with its wrapper's padding
to whole tiles: the kernel takes the flat (n,) arrays and masks its own
tail. The plain version is `ref.va`; `ops.va` picks between them by the
tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("va", "va", [_P, _P, _P, _L, _I, _P])
DTYPE_CODE = {torch.int32: 0, torch.float32: 1, torch.bfloat16: 2}


def va(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. a, b: contiguous (n,) of one dtype of
    `DTYPE_CODE` on one CUDA device. Returns a + b."""
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("va kernel needs CUDA tensors")
    if a.device != b.device:
        raise ValueError("va: tensors on different devices")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("va: tensors must be contiguous")
    out = torch.empty_like(a)
    KERNEL.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                  DTYPE_CODE[a.dtype],
                  torch.cuda.current_stream(a.device).cuda_stream)
    return out
