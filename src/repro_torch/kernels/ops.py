"""Public wrappers of the port's kernels, in the layouts of
`repro.kernels.ops`.

A wrapper checks shapes and dtypes, then sends CPU tensors to the plain
PyTorch version (`ref`) and CUDA tensors to the CUDA kernel, which
launches or raises: there is no fallback from the card to the plain path.
The streaming kernels (`va`, `gemv`, `reduction`, `stream_ops`) take the
flat 1-D arrays of `repro.kernels.ops` and return what it returns; the
kernels mask their own ragged edges, so nothing is padded.
"""

from __future__ import annotations

import numbers

import torch

from . import decode_attention as _da
from . import flash_attention as _fa
from . import gemv as _gemv
from . import microbench as _mb
from . import reduction as _red
from . import ref
from . import va as _va

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


def _check_vector(name, dtypes, *tensors):
    for t in tensors:
        if t.dim() != 1:
            raise ValueError(f"{name}: want a 1-D array, got shape "
                             f"{tuple(t.shape)}")
        if t.dtype not in dtypes:
            raise ValueError(f"{name}: dtype must be one of {dtypes}, got "
                             f"{t.dtype}")


def va(a, b):
    """a + b over (n,) arrays of one dtype: int32 (wraps), f32 or bf16."""
    _check_vector("va", tuple(_va.DTYPE_CODE), a, b)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(f"va: a and b differ: {tuple(a.shape)} {a.dtype}, "
                         f"{tuple(b.shape)} {b.dtype}")
    if a.device.type == "cpu":
        return ref.va(a, b)
    return _va.va(a, b)


def gemv(A, x):
    """y = A x for A (M, K), x (K,), each f32 or bf16; f32 accumulation,
    y (M,) in A's dtype."""
    dtypes = tuple(_gemv.DTYPE_CODE)
    if A.dim() != 2 or A.dtype not in dtypes:
        raise ValueError(f"gemv: A must be 2-D of one of {dtypes}, got "
                         f"{tuple(A.shape)} {A.dtype}")
    _check_vector("gemv", dtypes, x)
    if x.shape[0] != A.shape[1]:
        raise ValueError(f"gemv: x {tuple(x.shape)} does not match A "
                         f"{tuple(A.shape)}")
    if A.device.type == "cpu":
        return ref.gemv(A, x)
    return _gemv.gemv(A, x)


def reduction(x):
    """Sum of an (n,) int32, f32 or bf16 array as a 0-dim f32 tensor."""
    _check_vector("reduction", tuple(_red.DTYPE_CODE), x)
    if x.device.type == "cpu":
        return ref.reduction(x)
    return _red.reduction(x)


def stream_ops(x, ops_per_elem: int):
    """The Fig. 2 microbenchmark: `ops_per_elem` dependent adds of i + 1
    on each element of an (n,) int32 (wrapping) or f32 array."""
    _check_vector("stream_ops", tuple(_mb.DTYPE_CODE), x)
    if isinstance(ops_per_elem, bool) or not isinstance(
            ops_per_elem, numbers.Integral) or ops_per_elem < 0:
        raise ValueError(f"stream_ops: ops_per_elem must be an int >= 0, "
                         f"got {ops_per_elem!r}")
    ops_per_elem = int(ops_per_elem)
    if x.device.type == "cpu":
        return ref.microbench_stream(x, ops_per_elem)
    return _mb.stream_ops(x, ops_per_elem)


def kernels():
    """name -> launch counter object of every kernel the port has."""
    return {"decode_attention": _da.KERNEL, "flash_attention": _fa.KERNEL,
            "va": _va.KERNEL, "reduction": _red.KERNEL,
            "stream_ops": _mb.KERNEL, "gemv": _gemv.KERNEL}
