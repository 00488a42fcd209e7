"""Public wrappers of the port's kernels, in the layouts of
`repro.kernels.ops`.

A wrapper checks shapes and dtypes, then sends CPU tensors to the plain
PyTorch version (`ref`) and CUDA tensors to the CUDA kernel, which
launches or raises: there is no fallback from the card to the plain path.
The streaming kernels (`va`, `gemv`, `reduction`, `stream_ops`) take the
flat 1-D arrays of `repro.kernels.ops` and return what it returns; the
kernels mask their own ragged edges, so nothing is padded. So do the PrIM
bank-local kernels behind `scan`, `histogram`, `ts_min` and `transpose`.

`gemv`, `reduction` and the scan entry points take `acc`: f32 (the
default, the Pallas kernels' contract) or int32, the int32 route, for
int32 data: int32 out, every add and multiply wrapping at 2^32, which is
what the reference's PrIM workloads compute with x64 off. `scan_blocks`,
`tile_offsets` and `add_offsets` expose SCAN's steps for `repro_torch.prim`,
which puts the exchange between the banks between them.
"""

from __future__ import annotations

import numbers

import torch

from . import decode_attention as _da
from . import flash_attention as _fa
from . import gemv as _gemv
from . import histogram as _hst
from . import microbench as _mb
from . import reduction as _red
from . import ref
from . import scan_block as _scan
from . import trns as _trns
from . import ts as _ts
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


def _check_acc(name, acc, *tensors):
    if acc == torch.float32:
        return
    if acc != torch.int32 or any(t.dtype != torch.int32 for t in tensors):
        raise ValueError(f"{name}: acc must be f32, or int32 with int32 "
                         f"inputs; got acc {acc}, inputs "
                         f"{[t.dtype for t in tensors]}")


def gemv(A, x, acc=torch.float32):
    """y = A x for A (M, K), x (K,), each f32 or bf16; f32 accumulation,
    y (M,) in A's dtype. acc int32: A and x int32, y int32 (wrapping)."""
    if acc != torch.float32:
        _check_acc("gemv", acc, A, x)
        if A.dim() != 2 or x.dim() != 1 or x.shape[0] != A.shape[1]:
            raise ValueError(f"gemv: want A (M, K) and x (K,), got "
                             f"{tuple(A.shape)}, {tuple(x.shape)}")
        if A.device.type == "cpu":
            return ref.gemv(A, x, acc)
        return _gemv.gemv(A, x)
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


def reduction(x, acc=torch.float32):
    """Sum of an (n,) int32, f32 or bf16 array as a 0-dim f32 tensor; acc
    int32: of an int32 array as a 0-dim int32 (wrapping)."""
    _check_vector("reduction", tuple(_red.DTYPE_CODE), x)
    _check_acc("reduction", acc, x)
    if x.device.type == "cpu":
        return ref.reduction(x, acc)
    return _red.reduction(x, acc)


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


def scan(x, acc=torch.float32):
    """Inclusive prefix sum of an (n,) int32 or f32 array through SCAN-SSA's
    phases (f32 inside, result in x's dtype, int32 truncated; acc int32:
    int32 inside, wrapping): the `scan_blocks` kernel, a fixed-order scan
    of the tile totals on the same device (`tile_offsets`), the
    `add_offsets` kernel."""
    _check_vector("scan", tuple(_scan.DTYPE_CODE), x)
    _check_acc("scan", acc, x)
    if x.device.type == "cpu":
        return ref.scan(x, acc)
    scans, totals = _scan.scan_blocks(x, acc)
    return _scan.add_offsets(scans, tile_offsets(totals), x.dtype)


def scan_blocks(x, acc=torch.float32):
    """SCAN's phase 1 on an (n,) int32 or f32 array: (scans (n,), totals
    (ceil(n / 8192),)) of each 8192-element tile, both of `acc`."""
    _check_vector("scan_blocks", tuple(_scan.DTYPE_CODE), x)
    _check_acc("scan_blocks", acc, x)
    if x.device.type == "cpu":
        return ref.scan_blocks(x, acc)
    return _scan.scan_blocks(x, acc)


def tile_offsets(totals):
    """SCAN's step between its two phases within a bank: each tile's
    exclusive offset from the tile totals of `scan_blocks`, in their dtype,
    by a fixed-order scan on their device (plain torch ops, no kernel)."""
    return ref.tile_offsets(totals)


def add_offsets(scans, offsets, dtype=torch.float32):
    """SCAN's phase 3: scans (n,) plus one offset per 8192-element tile,
    both f32 (out f32, or int32 truncated) or both int32 (out int32)."""
    if scans.device.type == "cpu":
        _scan.check_add_offsets(scans, offsets, dtype)
        return ref.add_offsets(scans, offsets, dtype)
    return _scan.add_offsets(scans, offsets, dtype)    # checks its arguments


def histogram(x, bins: int):
    """int32 counts of an (n,) uint32 array (or int32, read as the same
    bits) over `bins` buckets, bucket (x * bins) >> 12 in uint32; buckets
    >= bins count nowhere. 1 <= bins <= 8192 (the kernel's shared-memory
    histogram), on the CPU too."""
    _check_vector("histogram", _hst.DTYPES, x)
    if isinstance(bins, bool) or not isinstance(bins, numbers.Integral) \
            or not 1 <= bins <= _hst.MAX_BINS:
        raise ValueError(f"histogram: bins must be an int in [1, "
                         f"{_hst.MAX_BINS}], got {bins!r}")
    bins = int(bins)
    if x.device.type == "cpu":
        return ref.histogram(x, bins)
    return _hst.histogram(x, bins)


def ts_min(series, query):
    """(min squared distance, its window) of query (m,) over the windows of
    series (n,), each int32 or f32, 1 <= m <= min(n, 512): a 0-dim f32
    and the first index of the minimum as a 0-dim int32."""
    _check_vector("ts_min", tuple(_ts.DTYPE_CODE), series, query)
    n, m = series.numel(), query.numel()
    if not 1 <= m <= min(n, _ts.MAX_M):
        raise ValueError(f"ts_min: want 1 <= m <= min(n, {_ts.MAX_M}), got "
                         f"n {n}, m {m}")
    if series.device.type == "cpu":
        d = ref.ts_dists(series, query)
    else:
        d = _ts.ts_dists(series, query)
    i = torch.argmin(d)        # the first minimum, as jnp.argmin
    return d[i], i.to(torch.int32)


def transpose(A):
    """(M, N) -> (N, M) for an f32 or int32 matrix, or (B, M, N) ->
    (B, N, M) for a batch of them (B < 65536)."""
    if A.dim() not in (2, 3) or A.dtype not in _trns.DTYPES:
        raise ValueError(f"transpose: want a 2-D or 3-D array of one of "
                         f"{_trns.DTYPES}, got {tuple(A.shape)} {A.dtype}")
    if A.device.type == "cpu":
        return ref.trns(A)
    return _trns.transpose(A)


def kernels():
    """name -> launch counter object of every kernel the port has."""
    return {"decode_attention": _da.KERNEL, "flash_attention": _fa.KERNEL,
            "va": _va.KERNEL, "reduction": _red.KERNEL,
            "stream_ops": _mb.KERNEL, "gemv": _gemv.KERNEL,
            "scan_blocks": _scan.SCAN_BLOCKS,
            "add_offsets": _scan.ADD_OFFSETS, "histogram": _hst.KERNEL,
            "ts_dists": _ts.KERNEL, "transpose": _trns.KERNEL}
