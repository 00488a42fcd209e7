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
what the reference's PrIM workloads compute with x64 off. `scan` on the
int32 route and `scan_add` (the scan plus one offset) are one pass of the
single-pass kernel; `scan_blocks`, `tile_offsets` and `add_offsets`
expose the pair's steps.

`flash_attention` is differentiable: where a gradient is asked of it, it
runs as an autograd Function whose forward also keeps each row's
log-sum-exp and whose backward is the `flash_attention_bwd` kernel (the
plain `ref.flash_attention_bwd` on the CPU). `decode_attention` has no
gradient and raises where one is asked of it.

On a mesh (DTensor arguments) both attention wrappers run through
`local_map`: the kernel (or its plain version, by the local tensors'
device) runs on each device's shard. Flash attention takes q's
placements for all three (batch and heads may be sharded, never the
sequence or head dim; the model repeats K/V to all heads before it
shards heads, `layers.heads_for_kernel`). Decode attention takes the
cache's: where the cache's sequence is sharded (flash-decoding), each
device attends over its own slots and the partial results merge by
the log-sum-exp that the kernel returns beside its output (the plain
version's on the CPU).
"""

from __future__ import annotations

import contextlib
import functools
import numbers

import torch

from ..dist import is_dtensor, local_extent, replicate_uneven
from . import decode_attention as _da
from . import flash_attention as _fa
from . import flash_attention_bwd as _fab
from . import gemv as _gemv
from . import histogram as _hst
from . import microbench as _mb
from . import reduction as _red
from . import ref
from . import scan_block as _scan
from . import trns as _trns
from . import ts as _ts
from . import va as _va
from ._build import LaunchCounter

DTYPES = (torch.float32, torch.bfloat16)

#: calls of the attention wrappers on DTensors, each running its kernel
#: (or plain version) on the local shards through `local_map`: "flash"
#: and "decode"
SHARDED = LaunchCounter()


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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("decode_attention has no gradient: run it under "
                           "torch.no_grad() or on inputs that need none")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: want q (B,H,hd), k = v "
                         f"(B,W,KVH,hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match cache {tuple(k.shape)}")
    if is_dtensor(k):
        return _sharded_decode(q, k, v, lengths)
    if isinstance(lengths, int):
        # filled on the device: a copy from the host would wait for it,
        # which a CUDA graph's capture refuses
        lengths = torch.full((b,), lengths, dtype=torch.int32,
                             device=q.device)
    lengths = torch.as_tensor(lengths, dtype=torch.int32, device=q.device)
    if lengths.dim() == 0:
        lengths = lengths.expand(b).contiguous()
    return _decode_forward(q, k, v, lengths)


def _decode_forward(q, k, v, lengths, return_lse=False):
    """Decode attention by device: the plain version for CPU tensors (one
    op under `kernel_ops`), else the kernel (which launches or raises).
    lengths: int32 (B,)."""
    if q.device.type == "cpu":
        if _AS_OPS[0]:
            out, lse = torch.ops.repro_torch.decode(q, k, v, lengths)
            return (out, lse) if return_lse else out
        return ref.decode_attention(q, k, v, lengths, return_lse)
    return _da.decode_attention(q, k, v, lengths, return_lse)


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd). Causal and window masks
    count key positions from 0 and query positions from `q_offset` >= 0
    (a later chunk of a chunked prefill); window 0 means none."""
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
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got "
                         f"{q_offset}")
    if is_dtensor(q):
        return _sharded_flash(q, k, v, causal, window, q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        _fab.check_supported(q.shape[1], k.shape[1], q.shape[3], window,
                             q_offset)
        return _FlashAttention.apply(q, k, v, causal, window)
    return _flash_forward(q, k, v, causal, window, q_offset)


def _flash_forward(q, k, v, causal, window, q_offset, return_lse=False):
    """The forward by device: the plain version for CPU tensors (one op
    under `kernel_ops`), else the kernel (which launches or raises)."""
    if q.device.type == "cpu":
        if _AS_OPS[0]:
            out, lse = torch.ops.repro_torch.flash_fwd(q, k, v, causal,
                                                       window, q_offset)
            return (out, lse) if return_lse else out
        return ref.flash_attention(q, k, v, causal, window, q_offset,
                                   return_lse)
    return _fa.flash_attention(q, k, v, causal, window, q_offset, return_lse)


def _flash_backward(q, k, v, out, lse, dout, causal, window):
    """The backward by device: `ref.flash_attention_bwd` for CPU tensors
    (one op under `kernel_ops`), else the backward kernel."""
    if q.device.type == "cpu":
        if _AS_OPS[0]:
            return torch.ops.repro_torch.flash_bwd(q, k, v, out, lse, dout,
                                                   causal, window)
        return ref.flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                       window)
    return _fab.flash_attention_bwd(q, k, v, out, lse, dout, causal, window)


_AS_OPS = [False]


@contextlib.contextmanager
def kernel_ops():
    """A context in which each flash forward and backward and each decode
    attention on CPU tensors is one custom op, `repro_torch::flash_fwd`,
    `::flash_bwd` and `::decode`, as the card runs one kernel: its values
    are the plain version's, on fake tensors it gives its outputs' shapes
    alone. `core.census` counts such an op as the kernel's products and
    the bytes of its inputs and outputs, without the plain version's
    score-sized intermediates, which no kernel holds. `launch.dryrun`
    traces under it."""
    _register_kernel_ops()
    prev = _AS_OPS[0]
    _AS_OPS[0] = True
    try:
        yield
    finally:
        _AS_OPS[0] = prev


@functools.cache
def _register_kernel_ops() -> None:
    # schemas spelled out: this module's annotations are strings
    @torch.library.custom_op(
        "repro_torch::flash_fwd", mutates_args=(),
        schema="(Tensor q, Tensor k, Tensor v, bool causal, int window, "
               "int q_offset) -> (Tensor, Tensor)")
    def flash_fwd(q, k, v, causal, window, q_offset):
        return ref.flash_attention(q, k, v, causal, window, q_offset, True)

    @flash_fwd.register_fake
    def _(q, k, v, causal, window, q_offset):
        b, sq, h, _ = q.shape
        acc = torch.promote_types(q.dtype, torch.float32)
        return q.new_empty(q.shape), q.new_empty((b, h, sq), dtype=acc)

    @torch.library.custom_op(
        "repro_torch::flash_bwd", mutates_args=(),
        schema="(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
               "Tensor dout, bool causal, int window) -> "
               "(Tensor, Tensor, Tensor)")
    def flash_bwd(q, k, v, out, lse, dout, causal, window):
        return ref.flash_attention_bwd(q, k, v, out, lse, dout, causal,
                                       window)

    @flash_bwd.register_fake
    def _(q, k, v, out, lse, dout, causal, window):
        return q.new_empty(q.shape), k.new_empty(k.shape), \
            v.new_empty(v.shape)

    @torch.library.custom_op(
        "repro_torch::decode", mutates_args=(),
        schema="(Tensor q, Tensor k, Tensor v, Tensor lengths) -> "
               "(Tensor, Tensor)")
    def decode(q, k, v, lengths):
        return ref.decode_attention(q, k, v, lengths, True)

    @decode.register_fake
    def _(q, k, v, lengths):
        acc = torch.promote_types(q.dtype, torch.float32)
        return q.new_empty(q.shape), q.new_empty(q.shape[:2], dtype=acc)


class _FlashAttention(torch.autograd.Function):
    """Flash attention with a gradient (q_offset 0). The forward runs
    `_flash_forward` with the log-sum-exp and saves q, k, v, the output and
    the log-sum-exp; the backward runs `_flash_backward`. Each picks its
    primitive by device; neither falls back to the other."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _flash_forward(q, k, v, causal, window, 0, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _flash_backward(q, k, v, out, lse, dout, ctx.causal,
                                ctx.window)
        return (*grads, None, None)


def _replicated(x, mesh):
    """`x` as a DTensor on `mesh`: itself if it is one, else replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _sharded_flash(q, k, v, causal, window, q_offset):
    """`flash_attention` of DTensors: the wrapper on each device's shard
    (`local_map` on q's placements), with its gradient through the same
    autograd Function."""
    from torch.distributed.tensor import Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    plc = replicate_uneven(q.placements, q.shape, mesh)
    if any(p.is_shard() and p.dim in (1, 3) for p in plc) or \
            any(p.is_partial() for p in plc):
        raise ValueError(f"flash_attention: q's placements {plc} shard the "
                         f"sequence or head dim; shard batch or heads only")
    k, v = _replicated(k, mesh), _replicated(v, mesh)
    if k.shape[2] != q.shape[2] and any(
            p == Shard(2) and mesh.size(i) > 1 for i, p in enumerate(plc)):
        raise ValueError("flash_attention: heads are sharded, so k and v "
                         "need all H heads (repeat K/V before sharding)")
    SHARDED.count("flash")
    fn = local_map(lambda q, k, v: flash_attention(q, k, v, causal, window,
                                                   q_offset),
                   out_placements=list(plc), in_placements=(plc, plc, plc),
                   redistribute_inputs=True, device_mesh=mesh)
    return fn(q, k, v)


def _sharded_decode(q, k, v, lengths):
    """`decode_attention` of DTensor caches (module docstring): the kernel
    on each device's rows, heads and sequence shard. Where the sequence
    is sharded, each shard's output is weighted by exp(its log-sum-exp -
    the max over shards) and the weighted outputs summed over the shards
    and divided by the summed weights; an empty shard weighs 0."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = k.device_mesh
    kp = replicate_uneven(k.placements, k.shape, mesh)
    # q (B,H,hd): the cache's batch and head shards, replicated over its
    # sequence shards; lengths (B,) the batch shards
    qp = tuple(Shard(0) if p == Shard(0) else Shard(1) if p == Shard(2)
               else Replicate() for p in kp)
    lp = tuple(Shard(0) if p == Shard(0) else Replicate() for p in kp)
    q, v = _replicated(q, mesh), _replicated(v, mesh)
    lengths = _replicated(torch.as_tensor(lengths, dtype=torch.int32,
                                          device=q.device), mesh)
    if lengths.dim() == 0:
        lengths = lengths.expand(q.shape[0])
    seq_dims = [i for i, p in enumerate(kp)
                if p == Shard(1) and mesh.size(i) > 1]
    SHARDED.count("decode")
    if not seq_dims:
        fn = local_map(decode_attention, out_placements=list(qp),
                       in_placements=(qp, kp, kp, lp),
                       redistribute_inputs=True, device_mesh=mesh)
        return fn(q, k, v, lengths)
    shape, offset = local_extent(k.shape, mesh, kp)
    lo, n_loc = offset[1], shape[1]

    def part(q, k, v, lengths):
        n = torch.clamp(lengths - lo, 0, n_loc)
        o, lse = _decode_forward(q, k, v, torch.clamp(n, min=1), True)
        lse = torch.where(n[:, None] > 0, lse, torch.full_like(lse, -1e30))
        return o[None], lse[None]

    # each shard's (o, lse) as one slice of a new leading dim, sharded
    # over the cache's sequence mesh dims
    op = tuple(Shard(0) if i in seq_dims else Shard(p.dim + 1)
               if p.is_shard() else p for i, p in enumerate(qp))
    o, lse = local_map(part, out_placements=(list(op), list(op)),
                       in_placements=(qp, kp, kp, lp),
                       redistribute_inputs=True, device_mesh=mesh)(
                           q, k, v, lengths)
    m = lse.amax(0)
    w = torch.exp(lse - m)
    out = (o.float() * w[..., None]).sum(0) / w.sum(0)[..., None]
    return out.to(q.dtype).redistribute(mesh, qp)


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
    """Inclusive prefix sum of an (n,) int32 or f32 array. f32 accumulator
    (result in x's dtype, int32 truncated): SCAN-SSA's phases, the
    `scan_blocks` kernel, a fixed-order scan of the tile totals on the same
    device (`tile_offsets`), the `add_offsets` kernel; the f32 sums then
    have the same bits on every launch, which a look-back across tiles in
    the order the tiles finish would not give. acc int32 (int32 x, every
    add wrapping at 2^32, so any order gives the same bits): one launch of
    the single-pass `scan_lookback` kernel."""
    _check_vector("scan", tuple(_scan.DTYPE_CODE), x)
    _check_acc("scan", acc, x)
    if x.device.type == "cpu":
        return ref.scan(x, acc)
    if acc == torch.int32:
        return _scan.scan_lookback(x)
    scans, totals = _scan.scan_blocks(x, acc)
    return _scan.add_offsets(scans, tile_offsets(totals), x.dtype)


def scan_add(x, carry=None):
    """carry + the inclusive prefix sum of an (n,) int32 array, every add
    wrapping at 2^32: SCAN-RSS's bank-local pass, the reference's
    `jnp.cumsum(xb) + ob[0]`. carry: one int32 element on x's device, or
    None for 0. One launch of the single-pass `scan_lookback` kernel."""
    _scan.check_lookback(x, carry)
    if x.device.type == "cpu":
        return ref.scan_add(x, carry)
    return _scan.scan_lookback(x, carry)


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
    series (n,), each int32 or f32, n >= 1 and 1 <= m <= 512: a 0-dim f32
    and the first index of the minimum as a 0-dim int32. For m > n there is
    no window: (inf, 0), as the reference, with nothing launched."""
    _check_vector("ts_min", tuple(_ts.DTYPE_CODE), series, query)
    n, m = series.numel(), query.numel()
    if n < 1 or not 1 <= m <= _ts.MAX_M:
        raise ValueError(f"ts_min: want n >= 1 and 1 <= m <= {_ts.MAX_M}, "
                         f"got n {n}, m {m}")
    if m > n:
        return (torch.full((), float("inf"), device=series.device),
                torch.zeros((), dtype=torch.int32, device=series.device))
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
            "flash_attention_bwd": _fab.KERNEL,
            "va": _va.KERNEL, "reduction": _red.KERNEL,
            "stream_ops": _mb.KERNEL, "gemv": _gemv.KERNEL,
            "scan_blocks": _scan.SCAN_BLOCKS,
            "add_offsets": _scan.ADD_OFFSETS,
            "scan_lookback": _scan.LOOKBACK, "histogram": _hst.KERNEL,
            "ts_dists": _ts.KERNEL, "transpose": _trns.KERNEL}
