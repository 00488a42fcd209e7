"""The gradient of flash attention on the card: `csrc/flash_attention_bwd.cu`.

No `pallas_call` counterpart: the reference differentiates pure-JAX
attention, and the port's attention runs on the forward kernel
(`flash_attention`), so this backward is that kernel's gradient. It
recomputes P from q, k and the forward's log-sum-exp (FlashAttention-2)
without atomics: two launches give the same bits. The plain version is
`ref.flash_attention_bwd`; `ops.flash_attention`'s autograd Function
picks between them by the tensors' device.

Two routes, chosen here by `route(dtype, head_dim)` before the launch:
bf16 with a head_dim that is a multiple of 16 up to TC_MAX_HEAD_DIM runs
on the tensor cores (mma.sync, bf16 operands, f32 accumulators),
everything else (f32, other bf16 head dims) on CUDA cores in f32. No
route is taken because another failed.

It covers what training reaches and raises outside it: query positions
from 0, causal with or without a window or unmasked, every query row with
an unmasked key, hd <= MAX_HEAD_DIM. `KERNEL.launches` counts one per call
(three launches: D = rowsum(dO o O), dK/dV, dQ), `KERNEL.route_launches`
the calls of each route.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("flash_attention_bwd", "flash_attention_bwd",
                    [_P] * 10 + [_I] * 6 + [_L] * 9 + [_I] * 4 + [_P])
MAX_HEAD_DIM = 256
TC_MAX_HEAD_DIM = 128
ROUTES = ("cuda_core", "tensor_core")     # the kernel's route code is the index


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The route of a call: "tensor_core" for bf16 with head_dim a
    multiple of 16 up to TC_MAX_HEAD_DIM, else "cuda_core". f32 stays on
    CUDA cores on purpose: TF32 tensor cores cannot hold f32 gradients
    within 1e-4 of an f64 run, as chip_smoke.py phase 17 (b) does."""
    if dtype == torch.bfloat16 and head_dim % 16 == 0 \
            and 0 < head_dim <= TC_MAX_HEAD_DIM:
        return "tensor_core"
    return "cuda_core"


def check_supported(sq: int, skv: int, hd: int, window: int,
                    q_offset: int) -> None:
    """Raise unless the backward covers a call of these sizes: q_offset 0,
    hd <= MAX_HEAD_DIM, and no query row without an unmasked key (a
    window with Sq >= Skv + window)."""
    if q_offset:
        raise ValueError(f"flash_attention backward takes q_offset 0 only, "
                         f"got {q_offset}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention backward takes head_dim <= "
                         f"{MAX_HEAD_DIM}, got {hd}")
    if window > 0 and sq > skv + window - 1:
        raise ValueError(f"flash_attention backward: query rows from "
                         f"{skv + window - 1} on see no key (Sq {sq}, Skv "
                         f"{skv}, window {window})")


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of attention at q (B,Sq,H,hd), k, v (B,Skv,KVH,hd)
    (unit stride on hd), given the forward's `out` (B,Sq,H,hd) and its
    f32 log-sum-exp `lse` (B,H,Sq), and `dout`. Contiguous gradients in
    the inputs' dtype."""
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_bwd: head_dim must be contiguous")
    if len({t.dtype for t in (q, k, v, out, dout)}) != 1 or \
            q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("flash_attention_bwd: q, k, v, out, dout must share "
                         "one dtype, f32 or bf16")
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: want out, dout {tuple(q.shape)}"
                         f" and f32 lse {(b, h, sq)}; got {tuple(out.shape)}, "
                         f"{tuple(dout.shape)}, {tuple(lse.shape)} {lse.dtype}")
    check_supported(sq, skv, hd, window, 0)
    check_cuda("flash_attention_bwd", q, k, v, out, lse, dout,
               contiguous=False)
    out, lse, dout = out.contiguous(), lse.contiguous(), dout.contiguous()
    dq = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, kvh, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    d = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    r = route(q.dtype, hd)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), d.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  b, sq, skv, h, kvh, hd, *strides, int(causal), int(window),
                  int(q.dtype == torch.bfloat16), ROUTES.index(r),
                  torch.cuda.current_stream(q.device).cuda_stream, route=r)
    return dq, dk, dv
