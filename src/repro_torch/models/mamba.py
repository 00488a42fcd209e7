"""Mamba (selective SSM) block for the jamba hybrid architecture.

Counterpart of `repro.models.mamba`. Prefill runs the chunked scan: the
sequence is split into `cfg.ssm_chunk`-sized chunks, a Python loop
carries the state across them, and within a chunk the linear recurrence
``h_t = dA_t * h_{t-1} + dB_t x_t`` is solved by a doubling scan over the
chunk's steps (log2(chunk) elementwise passes, the composition the
reference's `jax.lax.associative_scan` applies in another order). Only
one (B, chunk, d_inner, d_state) state transient lives at a time. Decode
is the single-step recurrence. The depthwise causal conv (k = 4) is a sum
of shifts.

The state `h` and the scan run in f32 (f64 in an f64 model), whatever the
model's dtype, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as L
from .config import ModelConfig
from .sharding import NO_SHARDING, ParamDef, Shardings


def mamba_defs(cfg: ModelConfig, name: str) -> dict:
    d, di, ds, r = cfg.d_model, cfg.d_inner, cfg.ssm_d_state, cfg.dt_rank
    k = cfg.ssm_d_conv
    return {
        "in_proj": ParamDef((d, 2 * di), ("fsdp", "tp"), f"{name}.in_proj"),
        "conv_w": ParamDef((k, di), (None, "tp"), f"{name}.conv_w", "small"),
        "conv_b": ParamDef((di,), ("tp",), f"{name}.conv_b", "zeros"),
        "x_proj": ParamDef((di, r + 2 * ds), ("tp", None), f"{name}.x_proj"),
        "dt_proj": ParamDef((r, di), (None, "tp"), f"{name}.dt_proj"),
        "dt_bias": ParamDef((di,), ("tp",), f"{name}.dt_bias", "zeros"),
        "A_log": ParamDef((di, ds), ("tp", None), f"{name}.A_log", "ones"),
        "D": ParamDef((di,), ("tp",), f"{name}.D", "ones"),
        "out_proj": ParamDef((di, d), ("tp", "fsdp"), f"{name}.out_proj"),
    }


def _causal_conv(x, w, b, conv_state=None):
    """Depthwise causal conv over S as a sum of shifts.
    x: (B,S,di); w: (k,di); conv_state: (B,k-1,di) history or None.
    Returns (out, new_state), new_state the last k-1 inputs."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)          # (B, S+k-1, di)
    out = xp[:, 0:x.shape[1]] * w[0]
    for i in range(1, k):
        out = out + xp[:, i:i + x.shape[1]] * w[i]
    return out + b, xp[:, -(k - 1):]


def _scan_in_chunk(a, b):
    """Inclusive scan of the affine maps h -> a_t h + b_t along dim 1, by
    doubling: after the pass with stride d, step t holds the composition of
    steps max(0, t-2d+1)..t. Returns (A_t, B_t) with h_t = A_t h_0 + B_t."""
    n, d = a.shape[1], 1
    while d < n:
        a, b = (torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1),
                torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1))
        d *= 2
    return a, b


def _ssm_scan_chunked(dA, dBx, C, h0, chunk: int):
    """Solve h_t = dA_t h_{t-1} + dBx_t and contract y_t = h_t · C_t inside
    the chunk loop, so the (B,S,di,ds) state sequence is never
    materialized. dA, dBx: (B,S,di,ds); C: (B,S,ds); S % chunk == 0.
    Returns y (B,S,di) and the final h (B,di,ds)."""
    b, s, di, ds = dA.shape
    assert s % chunk == 0, (s, chunk)
    h, ys = h0, []
    for c0 in range(0, s, chunk):
        aa, bb = _scan_in_chunk(dA[:, c0:c0 + chunk], dBx[:, c0:c0 + chunk])
        hs = aa * h[:, None] + bb            # (B,chunk,di,ds) transient
        ys.append(torch.einsum("bcds,bcs->bcd", hs, C[:, c0:c0 + chunk]))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_forward(x, p, cfg: ModelConfig, state=None,
                  shd: Shardings = NO_SHARDING):
    """x: (B,S,D). state: None (training) or {"h": (B,di,ds), "conv":
    (B,k-1,di)} for prefill and decode. Returns (y, new_state); the caller
    writes new_state into the cache."""
    b, s, d = x.shape
    di, ds, r = cfg.d_inner, cfg.ssm_d_state, cfg.dt_rank
    decoding = state is not None and s == 1
    acc = torch.promote_types(x.dtype, torch.float32)

    # on a mesh each product's operands are laid out as GSPMD lays them:
    # in_proj's columns, x_proj's and out_proj's contractions over tp, on
    # the batch rows (in_proj contracting over "data" where they do not
    # split: `Shardings.stationary`); in_proj's gradient comes back
    # column-sharded, as its output
    c = shd.stationary(b)
    xz = L._rows(x, shd, c) @ shd.lay(p["in_proj"].to(x.dtype), c, "tp")
    xin, z = L._grad_as_input(xz).chunk(2, dim=-1)
    xin = shd.act(xin, "batch", None, "tp")
    conv_state = state["conv"] if state is not None else None
    xin, new_conv = _causal_conv(xin, p["conv_w"].to(x.dtype),
                                 p["conv_b"].to(x.dtype), conv_state)
    xin = F.silu(xin)

    # the projection contracts the tp-sharded inner dim: its small output
    # (dt_rank + 2 d_state per token) is reduced to a replica at once, and
    # so is its gradient (a partial sum where dt, B and C meet tp-sharded
    # operands) before the product's backward
    x_proj = shd.lay(p["x_proj"].to(x.dtype), "tp", None)
    dbc = L._grad_as_input(shd.act(L._rows(xin, shd, "tp") @ x_proj,
                                   "batch", None, None))
    dt, B_, C_ = dbc.split([r, ds, ds], dim=-1)
    dt = F.softplus((dt @ p["dt_proj"].to(x.dtype)).to(acc)
                    + p["dt_bias"].to(acc))
    A = -torch.exp(p["A_log"].to(acc))                     # (di, ds)
    xin_f = xin.to(acc)
    dA = torch.exp(dt[..., None] * A)                      # (B,S,di,ds)
    dBx = (dt * xin_f)[..., None] * B_.to(acc)[:, :, None, :]
    # keep the (B,S,di,ds) intermediates sharded on di over tp, as the
    # reference constrains them
    dA = shd.act(dA, "batch", None, "tp", None)
    dBx = shd.act(dBx, "batch", None, "tp", None)

    h0 = (state["h"].to(acc) if state is not None
          else torch.zeros((b, di, ds), dtype=acc, device=x.device))
    Cf = C_.to(acc)
    if decoding:
        h_final = dA[:, 0] * h0 + dBx[:, 0]
        y = torch.einsum("bds,bs->bd", h_final, Cf[:, 0])[:, None]
    else:
        chunk = min(cfg.ssm_chunk, s)
        pad = (-s) % chunk
        if pad:  # identity steps: h = 1*h + 0 (sliced off below)
            dA = torch.cat([dA, dA.new_ones((b, pad, di, ds))], dim=1)
            dBx = torch.cat([dBx, dBx.new_zeros((b, pad, di, ds))], dim=1)
            Cf = torch.cat([Cf, Cf.new_zeros((b, pad, ds))], dim=1)
        # local along batch and the inner dim: on a mesh each device
        # scans its own rows and channels
        sp = dA.shape[1]
        y, h_final = shd.local_with(
            lambda a, bx, c, h: _ssm_scan_chunked(a, bx, c, h, chunk),
            (dA, dBx, Cf, h0),
            (("batch", None, "tp", None), ("batch", None, "tp", None),
             ("batch", None, None), ("batch", "tp", None)),
            (((b, sp, di), ("batch", None, "tp")),
             ((b, di, ds), ("batch", "tp", None))))
        y = y[:, :s]

    y = shd.act(y, "batch", None, "tp")
    y = y + xin_f * p["D"].to(acc)
    y = y.to(x.dtype) * F.silu(z)
    out = shd.act(L._rows(y, shd, "tp")
                  @ shd.lay(p["out_proj"].to(x.dtype), "tp", None),
                  "batch", "seq", None)
    return out, {"h": h_final, "conv": new_conv}


def mamba_state_defs(cfg: ModelConfig, batch: int, name: str) -> dict:
    k = cfg.ssm_d_conv
    return {
        "h": ParamDef((batch, cfg.d_inner, cfg.ssm_d_state),
                      ("batch", "tp", None), f"{name}.h", "zeros"),
        "conv": ParamDef((batch, k - 1, cfg.d_inner),
                         ("batch", None, "tp"), f"{name}.conv", "zeros"),
    }
