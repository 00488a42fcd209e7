"""Prefill flash attention on the card: `csrc/flash_attention.cu`.

Replaces `repro/kernels/flash_attention.py::flash_attention_fwd` together
with its wrapper's KV repeat, fold and padding: the kernel reads
q (B,Sq,H,hd) and k, v (B,Skv,KVH,hd) in place through their strides. The
plain version is `ref.flash_attention`; `ops.flash_attention` picks
between them by the tensors' device.

Two routes, chosen here by `route(dtype, head_dim)` before the launch:
bf16 with a head_dim that is a multiple of 16 runs on the tensor cores
(mma.sync), everything else (f32, other bf16 head dims) on CUDA cores in
f32. No route is taken because another failed. `KERNEL.launches` counts
every launch, `KERNEL.route_launches` the launches of each route.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("flash_attention", "flash_attention",
                    [_P, _P, _P, _P] + [_I] * 6 + [_L] * 9 + [_I] * 4 + [_P])
MAX_HEAD_DIM = 256
ROUTES = ("cuda_core", "tensor_core")     # the kernel's route code is the index


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The route of a call: "tensor_core" for bf16 with head_dim a
    multiple of 16 up to MAX_HEAD_DIM, else "cuda_core". f32 stays on CUDA
    cores on purpose: TF32 tensor cores cannot hold a call within 1e-4 of
    an f64 run, as chip_smoke.py phase 4 does."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0 \
            and 0 < head_dim <= MAX_HEAD_DIM:
        return "tensor_core"
    return "cuda_core"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the kernel. q: (B,Sq,H,hd); k, v: (B,Skv,KVH,hd), each with
    unit stride on hd (other strides are free); one CUDA device; f32 or
    bf16. Returns a contiguous (B,Sq,H,hd) in q's dtype."""
    tensors = (q, k, v)
    check_cuda("flash_attention", *tensors, contiguous=False)
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash_attention: head_dim must be contiguous")
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {hd}")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    strides = [s for t in tensors for s in t.stride()[:3]]
    r = route(q.dtype, hd)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, sq, skv, h, kvh, hd, *strides, int(causal), int(window),
                  int(q.dtype == torch.bfloat16), ROUTES.index(r),
                  torch.cuda.current_stream(q.device).cuda_stream, route=r)
    return out
