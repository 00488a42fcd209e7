"""The two bank-local phases of PrIM SCAN-SSA on the card: `csrc/scan.cu`.

Replaces `repro/kernels/scan_block.py::scan_blocks` and `::add_offsets`,
together with `ops.scan`'s padding and final cast: the kernels take the
flat (n,) arrays, mask the ragged last tile, and `add_offsets` writes the
output type itself. Two routes: "f32" (f32 inside, the Pallas kernels'
contract) and "int32" (int32 data, scans, totals and offsets, wrapping at
2^32: what PrIM SCAN computes with x64 off); `route_launches` of each
kernel counts them. The plain versions are `ref.scan_blocks` and
`ref.add_offsets`; `ops.scan` runs the two phases with the fixed-order
scan of the tile totals on the card (`ops.tile_offsets`) between them.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda
from .ref import SCAN_TILE as TILE    # kTile in csrc/scan.cu

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SCAN_BLOCKS = CudaKernel("scan", "scan_blocks", [_P, _L, _I, _I, _P, _P, _P])
ADD_OFFSETS = CudaKernel("scan", "add_offsets",
                         [_P, _P, _L, _I, _I, _P, _P])
DTYPE_CODE = {torch.int32: 0, torch.float32: 1}
ACC_CODE = {torch.float32: 0, torch.int32: 1}   # the routes, by accumulator


def _route(acc: torch.dtype) -> str:
    return "int32" if acc == torch.int32 else "f32"


def scan_blocks(x: torch.Tensor, acc: torch.dtype = torch.float32
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch phase 1. x: contiguous (n,) int32 or f32 on a CUDA device;
    acc: f32, or int32 for int32 x. Returns (scans (n,), totals
    (ceil(n / 8192),)), both of `acc`."""
    check_cuda("scan_blocks", x)
    if x.dtype not in DTYPE_CODE or acc not in ACC_CODE \
            or (acc == torch.int32 and x.dtype != torch.int32):
        raise ValueError(f"scan_blocks kernel takes {tuple(DTYPE_CODE)} with "
                         f"acc f32, or int32 with acc int32; got {x.dtype}, "
                         f"acc {acc}")
    n = x.numel()
    scans = torch.empty(n, dtype=acc, device=x.device)
    totals = torch.empty(-(-n // TILE), dtype=acc, device=x.device)
    if n:
        SCAN_BLOCKS.launch(x.data_ptr(), n, DTYPE_CODE[x.dtype], ACC_CODE[acc],
                           scans.data_ptr(), totals.data_ptr(),
                           torch.cuda.current_stream(x.device).cuda_stream,
                           route=_route(acc))
    return scans, totals


def check_add_offsets(scans: torch.Tensor, offsets: torch.Tensor,
                      dtype: torch.dtype) -> None:
    """Raise unless scans (n,) and offsets (ceil(n / 8192),) share a dtype
    of `ACC_CODE` and `dtype` is an output of that route: f32 or int32
    (truncating) for f32 scans, int32 for int32 scans."""
    acc = scans.dtype
    if scans.dim() != 1 or offsets.dim() != 1 or acc not in ACC_CODE \
            or offsets.dtype != acc \
            or offsets.numel() != -(-scans.numel() // TILE) \
            or dtype not in DTYPE_CODE \
            or (acc == torch.int32 and dtype != torch.int32):
        raise ValueError(f"add_offsets: want scans (n,) and offsets "
                         f"(ceil(n / {TILE}),) of one dtype, f32 (out int32 "
                         f"or f32) or int32 (out int32), got {scans.dtype} "
                         f"{tuple(scans.shape)}, {offsets.dtype} "
                         f"{tuple(offsets.shape)}, {dtype}")


def add_offsets(scans: torch.Tensor, offsets: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch phase 3. scans: contiguous (n,); offsets (ceil(n / 8192),) of
    the scans' dtype. f32 scans (the f32 route): dtype int32 (truncates) or
    f32; int32 scans (the int32 route): dtype int32. Returns (n,)."""
    check_cuda("add_offsets", scans, offsets)
    check_add_offsets(scans, offsets, dtype)
    n = scans.numel()
    acc = scans.dtype
    out = torch.empty(n, dtype=dtype, device=scans.device)
    if n:
        ADD_OFFSETS.launch(scans.data_ptr(), offsets.data_ptr(), n,
                           ACC_CODE[acc], DTYPE_CODE[dtype], out.data_ptr(),
                           torch.cuda.current_stream(scans.device).cuda_stream,
                           route=_route(acc))
    return out
