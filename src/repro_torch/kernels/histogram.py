"""Histogram on the card: `csrc/histogram.cu`.

Replaces `repro/kernels/histogram.py::histogram_2d` together with its
wrapper's padding: int32 counts of uint32 values over `bins` buckets,
bucket (x * bins) >> 12 in uint32 arithmetic; a bucket >= bins counts
nowhere. The plain version is `ref.histogram`; `ops.histogram` picks
between them by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("histogram", "histogram", [_P, _L, _I, _P, _P])
DTYPES = (torch.uint32, torch.int32)     # int32 is read as the same bits
MAX_BINS = 8192       # kMaxBins in csrc/histogram.cu: 32 KB of shared memory


def histogram(x: torch.Tensor, bins: int) -> torch.Tensor:
    """Launch the kernel. x: contiguous (n,) uint32 or int32 on a CUDA
    device, n < 2^31; 1 <= bins <= MAX_BINS. Returns (bins,) int32 (the
    kernel zeroes the counts on the stream before it counts)."""
    check_cuda("histogram", x)
    if x.dtype not in DTYPES or not 1 <= bins <= MAX_BINS \
            or x.numel() >= 2 ** 31:
        raise ValueError(f"histogram kernel takes uint32/int32 (n < 2^31) "
                         f"and 1 <= bins <= {MAX_BINS}, got {x.dtype} "
                         f"{tuple(x.shape)}, bins {bins}")
    if not x.numel():
        return torch.zeros(bins, dtype=torch.int32, device=x.device)
    counts = torch.empty(bins, dtype=torch.int32, device=x.device)
    KERNEL.launch(x.data_ptr(), x.numel(), bins, counts.data_ptr(),
                  torch.cuda.current_stream(x.device).cuda_stream)
    return counts
