"""Plain PyTorch versions of the port's kernels.

Each computes the same function as its CUDA kernel, with the same
signature as its wrapper in `ops`. `ops` sends CPU tensors here; on the
card they serve only as the oracle the kernels are held to (tests and
`chip_smoke.py`). Softmax runs in f32 (or f64 for f64 inputs) and the
result is cast to q's dtype, as in `repro.kernels.ref`.
"""

from __future__ import annotations

import math

import torch


def _wide(x):
    """x in f32, or f64 if it already is: the softmax type."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def decode_attention(q, k, v, lengths):
    """q: (B,H,hd); k,v: (B,W,KVH,hd); lengths: int or int32 (B,) valid
    cache slots per row (slots [0, lengths[b]) attend). Returns (B,H,hd),
    GQA-aware, f32 softmax."""
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
    return o.reshape(b, h, hd).to(q.dtype)


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """q: (B,Sq,H,hd); k,v: (B,Skv,KVH,hd) — plain softmax attention with
    query and key positions both counted from 0."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if kvh != h:
        k = torch.repeat_interleave(k, h // kvh, dim=2)
        v = torch.repeat_interleave(v, h // kvh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", _wide(q), _wide(k)) / math.sqrt(hd)
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, _wide(v)).to(q.dtype)
