"""Public wrappers of the port's kernels, in the layouts of
`repro.kernels.ops`.

A wrapper checks shapes and dtypes, then sends CPU tensors to the plain
PyTorch version (`ref`) and CUDA tensors to the CUDA kernel, which
launches or raises: there is no fallback from the card to the plain path.
"""

from __future__ import annotations

import torch

from . import decode_attention as _da
from . import flash_attention as _fa
from . import ref

DTYPES = (torch.float32, torch.bfloat16)


def _check_dtypes(name, *tensors):
    dts = {t.dtype for t in tensors}
    if len(dts) != 1 or dts.pop() not in DTYPES:
        raise ValueError(f"{name}: q, k, v must share one dtype of "
                         f"{DTYPES}, got {[t.dtype for t in tensors]}")


def decode_attention(q, k, v, lengths):
    """q: (B, H, hd); k, v: (B, W, KVH, hd); lengths: valid cache slots per
    row, an int (the Pallas contract: one length for the batch) or an
    int32 (B,) tensor. Slots [0, lengths[b]) attend; 1 <= lengths <= W."""
    _check_dtypes("decode_attention", q, k, v)
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: want q (B,H,hd), k = v "
                         f"(B,W,KVH,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match cache {tuple(k.shape)}")
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=q.device)
    if lengths.dim() == 0:
        lengths = lengths.expand(b).contiguous()
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, lengths)
    return _da.decode_attention(q, k, v, lengths)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd). Causal and window masks
    count query and key positions from 0; window 0 means none."""
    _check_dtypes("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B,Sq,H,hd), k = v "
                         f"(B,Skv,KVH,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if (k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]
            or q.shape[2] % k.shape[2]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if window < 0:
        raise ValueError(f"flash_attention: window must be >= 0, got {window}")
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal, window)
    return _fa.flash_attention(q, k, v, causal, window)


def kernels():
    """name -> launch counter object of every kernel the port has."""
    return {"decode_attention": _da.KERNEL, "flash_attention": _fa.KERNEL}
