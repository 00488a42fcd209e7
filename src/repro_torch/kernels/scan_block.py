"""The two bank-local phases of PrIM SCAN-SSA on the card: `csrc/scan.cu`.

Replaces `repro/kernels/scan_block.py::scan_blocks` and `::add_offsets`,
together with `ops.scan`'s padding and final cast: the kernels take the
flat (n,) arrays, mask the ragged last tile, and `add_offsets` writes the
output type itself. The plain versions are `ref.scan_blocks` and
`ref.add_offsets`; `ops.scan` runs the two phases with the fixed-order
scan of the tile totals on the card (`ref.tile_offsets`) between them.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda
from .ref import SCAN_TILE as TILE    # kTile in csrc/scan.cu

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SCAN_BLOCKS = CudaKernel("scan", "scan_blocks", [_P, _L, _I, _P, _P, _P])
ADD_OFFSETS = CudaKernel("scan", "add_offsets", [_P, _P, _L, _I, _P, _P])
DTYPE_CODE = {torch.int32: 0, torch.float32: 1}


def scan_blocks(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch phase 1. x: contiguous (n,) int32 or f32 on a CUDA device.
    Returns (scans (n,) f32, totals (ceil(n / 8192),) f32)."""
    check_cuda("scan_blocks", x)
    if x.dtype not in DTYPE_CODE:
        raise ValueError(f"scan_blocks kernel takes {tuple(DTYPE_CODE)}, got "
                         f"{x.dtype}")
    n = x.numel()
    scans = torch.empty(n, dtype=torch.float32, device=x.device)
    totals = torch.empty(-(-n // TILE), dtype=torch.float32, device=x.device)
    if n:
        SCAN_BLOCKS.launch(x.data_ptr(), n, DTYPE_CODE[x.dtype],
                           scans.data_ptr(), totals.data_ptr(),
                           torch.cuda.current_stream(x.device).cuda_stream)
    return scans, totals


def add_offsets(scans: torch.Tensor, offsets: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch phase 3. scans: contiguous (n,) f32; offsets: f32
    (ceil(n / 8192),); dtype: int32 (truncates) or f32. Returns (n,)."""
    check_cuda("add_offsets", scans, offsets)
    n = scans.numel()
    if scans.dtype != torch.float32 or offsets.dtype != torch.float32 \
            or offsets.numel() != -(-n // TILE) or dtype not in DTYPE_CODE:
        raise ValueError(f"add_offsets: want f32 scans (n,), f32 offsets "
                         f"(ceil(n / {TILE}),) and an output dtype of "
                         f"{tuple(DTYPE_CODE)}, got {scans.dtype} "
                         f"{tuple(scans.shape)}, {offsets.dtype} "
                         f"{tuple(offsets.shape)}, {dtype}")
    out = torch.empty(n, dtype=dtype, device=scans.device)
    if n:
        ADD_OFFSETS.launch(scans.data_ptr(), offsets.data_ptr(), n,
                           DTYPE_CODE[dtype], out.data_ptr(),
                           torch.cuda.current_stream(scans.device).cuda_stream)
    return out
