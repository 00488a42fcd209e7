"""Decode attention on the card: `csrc/decode_attention.cu`.

Replaces `repro/kernels/decode_attention.py::decode_attention_grouped`.
One decode step of GQA attention, q (B,H,hd) over a KV cache
(B,W,KVH,hd), with a valid length per row. The plain version is
`ref.decode_attention`; `ops.decode_attention` picks between them by the
tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import CudaKernel, check_cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("decode_attention", "decode_attention",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
MAX_GROUP = 16     # query heads per KV head
MAX_HEAD_DIM = 256


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Launch the kernel. q: (B,H,hd); k, v: (B,W,KVH,hd); lengths: int32
    (B,) with 1 <= lengths[b] <= W (a documented precondition, not checked:
    that would cost a host sync). All on one CUDA device, contiguous;
    f32 or bf16. Returns (B,H,hd) in q's dtype."""
    tensors = (q, k, v, lengths)
    check_cuda("decode_attention", *tensors)
    b, h, hd = q.shape
    w, kvh = k.shape[1], k.shape[2]
    if h // kvh > MAX_GROUP or hd > MAX_HEAD_DIM or hd % 8:
        raise ValueError(f"decode_attention kernel takes at most {MAX_GROUP} "
                         f"query heads per KV head and a head_dim that is a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}; got "
                         f"{h // kvh} and {hd}")
    if lengths.dtype != torch.int32 or lengths.shape != (b,):
        raise ValueError(f"lengths must be int32 ({b},), got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    out = torch.empty_like(q)
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), b, kvh, h // kvh, w, hd,
                  int(q.dtype == torch.bfloat16),
                  torch.cuda.current_stream(q.device).cuda_stream)
    return out
