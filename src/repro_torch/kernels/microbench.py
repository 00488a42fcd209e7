"""The Fig. 2 streaming microbenchmark on the card: `csrc/microbench.cu`.

Replaces `repro/kernels/microbench.py::stream_ops` together with its
wrapper's padding: `ops_per_elem` dependent adds of i + 1 on each element
of an (n,) int32 or f32 array, read once and written once, so sweeping
`ops_per_elem` sweeps the operational intensity. The kernel really issues
every add (see the source); the plain version is
`ref.microbench_stream`, and `ops.stream_ops` picks between them by the
tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("microbench", "stream_ops", [_P, _P, _L, _I, _I, _P])
DTYPE_CODE = {torch.int32: 0, torch.float32: 1}


def stream_ops(x: torch.Tensor, ops_per_elem: int) -> torch.Tensor:
    """Launch the kernel. x: contiguous (n,) int32 or f32 on a CUDA device;
    ops_per_elem >= 0. Returns a new array of x's shape and dtype."""
    check_cuda("stream_ops", x)
    if not 0 <= ops_per_elem < 2 ** 31:
        raise ValueError(f"stream_ops: ops_per_elem {ops_per_elem} out of "
                         f"range")
    out = torch.empty_like(x)
    KERNEL.launch(x.data_ptr(), out.data_ptr(), x.numel(), int(ops_per_elem),
                  DTYPE_CODE[x.dtype],
                  torch.cuda.current_stream(x.device).cuda_stream)
    return out
