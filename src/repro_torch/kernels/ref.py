"""Plain PyTorch versions of the port's kernels.

Each computes the same function as its CUDA kernel, with the same
signature as its wrapper in `ops`. `ops` sends CPU tensors here; on the
card they serve only as the oracle the kernels are held to (tests and
`chip_smoke.py`). Softmax runs in f32 (or f64 for f64 inputs) and the
result is cast to q's dtype, as in `repro.kernels.ref`; `gemv` and
`reduction` accumulate in f32 as their oracles there do. The PrIM
bank-local kernels (`scan_blocks`/`add_offsets`, `histogram`, `ts_dists`,
`trns`) follow the Pallas bodies' arithmetic step by step, in f32, so the
CUDA kernels can match them bit for bit on the card. `gemv`, `reduction`
and the scan pair also have an int32 route (`acc=torch.int32`): int32 in
and out, every add and multiply wrapping at 2^32, as XLA's int32 does in
the reference's PrIM workloads (x64 off). Integer addition mod 2^32 is
associative, so these routes agree bit for bit in any order.
"""

from __future__ import annotations

import math

import torch


def _wide(x):
    """x in f32, or f64 if it already is: the softmax type."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def decode_attention(q, k, v, lengths, return_lse: bool = False):
    """q: (B,H,hd); k,v: (B,W,KVH,hd); lengths: int or int32 (B,) valid
    cache slots per row (slots [0, lengths[b]) attend). Returns (B,H,hd),
    GQA-aware, f32 softmax; with `return_lse` also each row's log-sum-exp
    of its scaled scores, (B,H) in the softmax type."""
    b, h, hd = q.shape
    w, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = _wide(q.reshape(b, kvh, g, hd))
    s = torch.einsum("bkgd,bwkd->bkgw", qg, _wide(k)) / math.sqrt(hd)
    lengths = torch.as_tensor(lengths, device=q.device).reshape(-1)
    mask = torch.arange(w, device=q.device)[None, :] < lengths[:, None]
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgw,bwkd->bkgd", p, _wide(v))
    o = o.reshape(b, h, hd).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(b, h)
    return o


def _flash_scores(q, k, causal, window, q_offset):
    """The masked scaled scores (B, H, Sq, Skv) in the softmax type, with
    masked entries -1e30, and k repeated over each KV head's group."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if kvh != h:
        k = torch.repeat_interleave(k, h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", _wide(q), _wide(k)) / math.sqrt(hd)
    return s.masked_fill(~_flash_mask(sq, skv, causal, window, q_offset,
                                      q.device), -1e30)


def _flash_mask(sq, skv, causal, window, q_offset, device):
    q_pos = torch.arange(q_offset, q_offset + sq, device=device)[:, None]
    k_pos = torch.arange(skv, device=device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    return mask


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    q_offset: int = 0, return_lse: bool = False):
    """q: (B,Sq,H,hd); k,v: (B,Skv,KVH,hd) — plain softmax attention with
    key positions counted from 0 and query positions from `q_offset`.
    With `return_lse` also each row's log-sum-exp of its scaled scores,
    (B,H,Sq) in the softmax type (f32, or f64 for f64 inputs)."""
    h, kvh = q.shape[2], k.shape[2]
    if kvh != h:
        v = torch.repeat_interleave(v, h // kvh, dim=2)
    s = _flash_scores(q, k, causal, window, q_offset)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, _wide(v)).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        window: int = 0):
    """(dq, dk, dv) of `flash_attention` (q_offset 0) by the explicit
    formulas, in the softmax type and cast to the inputs' dtype: P from the
    scores and the forward's `lse` (B,H,Sq), D = rowsum(dO o O),
    dV = P^T dO, dP = dO V^T, dS = P o (dP - D), dQ = dS K / sqrt(hd),
    dK = dS^T Q / sqrt(hd), with dK and dV summed over each KV head's
    group of query heads. Not autograd."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kw, vw = _wide(k), _wide(v)
    if g != 1:
        kw = torch.repeat_interleave(kw, g, dim=2)
        vw = torch.repeat_interleave(vw, g, dim=2)
    qw, dow = _wide(q), _wide(dout)
    mask = _flash_mask(sq, skv, causal, window, 0, q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", qw, kw) / math.sqrt(hd)
    p = torch.exp(s - lse.to(s.dtype)[..., None]).masked_fill(~mask, 0.0)
    d = (dow * _wide(out)).sum(-1).transpose(1, 2)              # (B,H,Sq)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dow)
    dp = torch.einsum("bqhd,bkhd->bhqk", dow, vw)
    ds = p * (dp - d[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kw) / math.sqrt(hd)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qw) / math.sqrt(hd)
    if g != 1:
        dk = dk.reshape(b, skv, kvh, g, hd).sum(3)
        dv = dv.reshape(b, skv, kvh, g, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def va(a, b):
    """Elementwise a + b (int32 wraps, bf16 rounds once)."""
    return a + b


def _wrap32(x):
    """int64 -> int32 keeping the low 32 bits (two's complement)."""
    return x.to(torch.int32)


def gemv(A, x, acc=torch.float32):
    """A: (M, K); x: (K,) -> (M,) in A's dtype, accumulated in f32; with
    acc int32 (int32 A and x), products and sums wrapping at 2^32: an int64
    multiply-and-sum cut to 32 bits (the card has no int32 matmul)."""
    if acc == torch.int32:
        return _wrap32((A.long() * x.long()).sum(1))
    return (A.float() @ x.float()).to(A.dtype)


def reduction(x, acc=torch.float32):
    """Sum of every element as a 0-dim f32 tensor, f32 accumulation; with
    acc int32 (int32 x), the sum wrapping at 2^32 as a 0-dim int32."""
    if acc == torch.int32:
        return _wrap32(x.long().sum())
    return torch.sum(x.float())


def microbench_stream(x, ops_per_elem: int):
    """Fig-2 microbenchmark: `ops_per_elem` dependent adds of i + 1 per
    element, in x's dtype (int32 wraps)."""
    if ops_per_elem == 0:
        return x.clone()
    y = x
    for i in range(ops_per_elem):
        y = y + (i + 1)
    return y


SCAN_ROWS, SCAN_LANES = 64, 128        # the reference's scan tile
SCAN_TILE = SCAN_ROWS * SCAN_LANES
HST_SHIFT = 12                         # histogram values are < 2**12


def _cumsum_doubling(y):
    """Inclusive prefix sum along the last axis by doubling: at step
    s = 1, 2, 4, ... every element from s on adds the one s before it, in
    y's dtype (f32; int32 wraps). The scan kernel adds in this order, so
    the two agree bit for bit on any data (torch.cumsum's order depends on
    the device)."""
    s = 1
    while s < y.shape[-1]:
        y = torch.cat((y[..., :s], y[..., s:] + y[..., :-s]), dim=-1)
        s *= 2
    return y


def scan_blocks(x, acc=torch.float32):
    """Phase 1 of SCAN-SSA on the flat (n,) array: the row-major inclusive
    scan of each 64x128 tile in `acc` (f32, or int32 for int32 x, wrapping),
    and each tile's total, as the Pallas body computes them (lane scan, row
    offsets = scan of the row totals minus the row totals, add). The ragged
    last tile counts as padded with zeros. Returns (scans (n,), totals
    (ceil(n / 8192),)), both of `acc`."""
    n = x.numel()
    tiles = -(-n // SCAN_TILE)
    xf = torch.zeros(tiles * SCAN_TILE, dtype=acc, device=x.device)
    xf[:n] = x
    lane = _cumsum_doubling(xf.view(tiles, SCAN_ROWS, SCAN_LANES))
    row_tot = lane[:, :, -1]
    row_off = _cumsum_doubling(row_tot) - row_tot
    full = lane + row_off[:, :, None]
    return full.reshape(-1)[:n], full[:, -1, -1].contiguous()


def tile_offsets(totals):
    """SCAN-SSA's step between the phases: each tile's exclusive offset as
    the inclusive scan of the totals minus the totals, in the totals' dtype
    (f32, as `repro.kernels.ops.scan` computes it; int32 wraps). The scan
    is the doubling one, on the totals' device: elementwise adds in a
    fixed order, so every launch and the CPU give the same bits
    (torch.cumsum on the card is a single-pass scan whose f32 sums depend
    on timing)."""
    return _cumsum_doubling(totals) - totals


def add_offsets(scans, offsets, dtype=torch.float32):
    """Phase 3 of SCAN-SSA: scans (n,) plus one offset per 8192 elements,
    both f32 (cast to `dtype`: f32 -> int32 truncates, as XLA's convert) or
    both int32 (int32, wrapping)."""
    n = scans.numel()
    pad = offsets.numel() * SCAN_TILE - n
    full = torch.nn.functional.pad(scans, (0, pad)).view(-1, SCAN_TILE)
    return (full + offsets[:, None]).view(-1)[:n].to(dtype)


def scan(x, acc=torch.float32):
    """Inclusive prefix sum of an (n,) array through SCAN-SSA's phases,
    `acc` inside (f32, or int32 for int32 x), returned in x's dtype
    (`repro.kernels.ops.scan`)."""
    scans, totals = scan_blocks(x, acc)
    return add_offsets(scans, tile_offsets(totals), x.dtype)


def scan_add(x, carry=None):
    """The single-pass int32 scan's plain version: the int32 scan of
    `scan` plus `carry` (one int32 element, or none), every add wrapping
    at 2^32, so that any order of the adds gives these bits."""
    y = scan(x, torch.int32)
    return y if carry is None else y + carry.reshape(1)


def histogram(x, bins: int):
    """int32 counts of (n,) uint32 values (int32 read as the same bits)
    over `bins` buckets, bucket (x * bins) >> 12 in uint32 arithmetic
    (wrapping); a bucket >= bins counts nowhere, as in the reference.
    torch's uint32 has no shifts, so the bits are widened to int64."""
    if x.dtype == torch.uint32:
        x = x.view(torch.int32)
    mask = 0xFFFFFFFF
    idx = ((x.to(torch.int64) & mask) * bins & mask) >> HST_SHIFT
    return torch.bincount(idx[idx < bins], minlength=bins).to(torch.int32)


def ts_dists(series, query):
    """f32 squared euclidean distance of query (m,) to each of the
    n - m + 1 windows of series (n,), summed over j = 0 .. m-1 in order,
    one shifted slice at a time, as the Pallas body does."""
    s, q = series.float(), query.float()
    nwin = s.numel() - q.numel() + 1
    acc = torch.zeros(nwin, dtype=torch.float32, device=s.device)
    for j in range(q.numel()):
        d = s[j:j + nwin] - q[j]
        acc = acc + d * d
    return acc


def trns(A):
    """(M, N) -> (N, M), or (B, M, N) -> (B, N, M)."""
    return A.transpose(-1, -2).contiguous()
