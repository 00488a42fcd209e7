"""The gradient of flash attention on the card: `csrc/flash_attention_bwd.cu`.

No `pallas_call` counterpart: the reference differentiates pure-JAX
attention, and the port's attention runs on the forward kernel
(`flash_attention`), so this backward is that kernel's gradient. It
recomputes P from q, k and the forward's log-sum-exp (FlashAttention-2),
on CUDA cores with f32 accumulators for f32 and bf16 inputs, without
atomics: two launches give the same bits. The plain version is
`ref.flash_attention_bwd`; `ops.flash_attention`'s autograd Function
picks between them by the tensors' device.

It covers what training reaches and raises outside it: query positions
from 0, causal with or without a window or unmasked, every query row with
an unmasked key, hd <= MAX_HEAD_DIM. `KERNEL.launches` counts one per call
(three launches: D = rowsum(dO o O), dK/dV, dQ), under route "cuda_core".
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
KERNEL = CudaKernel("flash_attention_bwd", "flash_attention_bwd",
                    [_P] * 10 + [_I] * 6 + [_L] * 9 + [_I] * 3 + [_P])
MAX_HEAD_DIM = 256
ROUTE = "cuda_core"


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
    check_cuda("flash_attention_bwd", q, k, v, out, lse, dout,
               contiguous=False)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention_bwd: head_dim must be contiguous")
    if len({t.dtype for t in (q, k, v, out, dout)}) != 1:
        raise ValueError("flash_attention_bwd: q, k, v, out, dout must share "
                         "one dtype")
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: want out, dout {tuple(q.shape)}"
                         f" and f32 lse {(b, h, sq)}; got {tuple(out.shape)}, "
                         f"{tuple(dout.shape)}, {tuple(lse.shape)} {lse.dtype}")
    check_supported(sq, skv, hd, window, 0)
    out, lse, dout = out.contiguous(), lse.contiguous(), dout.contiguous()
    dq = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, kvh, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    d = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  dout.data_ptr(), lse.data_ptr(), d.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  b, sq, skv, h, kvh, hd, *strides, int(causal), int(window),
                  int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream(q.device).cuda_stream, route=ROUTE)
    return dq, dk, dv
