"""Sliding-window distance on the card: `csrc/ts.cu`.

Replaces `repro/kernels/ts.py::ts_dists_tiled` together with its wrapper's
padding: the f32 squared euclidean distance of a query (m,) to each of
the n - m + 1 windows of a series (n,), summed over the query in order.
The plain version is `ref.ts_dists`; `ops.ts_min` picks between them by
the tensors' device and takes the first minimum.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("ts", "ts_dists", [_P, _L, _I, _P, _I, _I, _P, _P])
DTYPE_CODE = {torch.int32: 0, torch.float32: 1}
MAX_M = 512           # kMaxM in csrc/ts.cu (the reference's BLOCK)


def ts_dists(series: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. series (n,), query (m,): contiguous, int32 or f32
    each, on one CUDA device, 1 <= m <= min(n, MAX_M). Returns
    (n - m + 1,) f32."""
    check_cuda("ts_dists", series, query)
    if series.dtype not in DTYPE_CODE or query.dtype not in DTYPE_CODE:
        raise ValueError(f"ts_dists kernel takes {tuple(DTYPE_CODE)}, got "
                         f"{series.dtype}, {query.dtype}")
    n, m = series.numel(), query.numel()
    if not 1 <= m <= min(n, MAX_M):
        raise ValueError(f"ts_dists: want 1 <= m <= min(n, {MAX_M}), got "
                         f"n {n}, m {m}")
    out = torch.empty(n - m + 1, dtype=torch.float32, device=series.device)
    KERNEL.launch(series.data_ptr(), n, DTYPE_CODE[series.dtype],
                  query.data_ptr(), m, DTYPE_CODE[query.dtype],
                  out.data_ptr(),
                  torch.cuda.current_stream(series.device).cuda_stream)
    return out
