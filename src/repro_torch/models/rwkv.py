"""RWKV-6 (Finch) block: data-dependent-decay linear attention + channel mix.

Counterpart of `repro.models.rwkv`. The wkv state is (B, H, hs, hs) per
layer, updated per token:
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (faaaa * (k_t^T v_t) + S_t)
A prefill whose length is a multiple of WKV_CHUNK takes the chunked
parallel form (`_wkv_chunked`); any other length, and the decode step,
runs the per-token recurrence, a Python loop over the tokens. The state
and both routes run in f32 (f64 in an f64 model), whatever the model's
dtype. Attention-free: no attention kernel runs in an RWKV model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as L
from .config import ModelConfig
from .sharding import NO_SHARDING, ParamDef, Shardings

#: chunk length of the parallel wkv form. 8 * max |log w| (= 8 by the decay
#: clamp) keeps every pairwise exponent within f32 range.
WKV_CHUNK = 8


def _wkv_chunked(rh, kh, vh, wh, u, S0, chunk: int):
    """Chunked-parallel wkv: S_{t+1} = diag(w_t) S_t + k_t^T v_t and
    o_t = r_t (u ⊙ k_t^T v_t + S_t), the state carried once per chunk.

    Within a chunk (log space, c_t = sum_{i<t} log w_i from the chunk's
    start):
        o_t = (r_t e^{c_t}) S0 + sum_{j<t} [r_t·k_j e^{c_t - c_{j+1}}] v_j
              + (r_t·(u ⊙ k_t)) v_t
        S'  = diag(e^{c_C}) S0 + sum_j diag(e^{c_C - c_{j+1}}) k_j^T v_j
    Every exponent is a difference of same-chunk cumulative sums, at most
    chunk * 8 = 64 < 88.7 (the f32 exp range) by the decay clamp. The
    terms that do not involve the carried state are computed for all
    chunks at once; a loop over the chunks carries S.

    rh/kh/vh/wh: (B,S,H,hs); u: (H,hs); S0: (B,H,hs,hs).
    Returns (S_final, o (B,S,H,hs))."""
    b, s, h, hs = rh.shape
    n = s // chunk
    r, k, v, w = (t.reshape(b, n, chunk, h, hs) for t in (rh, kh, vh, wh))
    lw = torch.log(w)
    cum = torch.cumsum(lw, dim=2)              # c_{t+1}: sum_{i<=t}
    q = r * torch.exp(cum - lw)                # r_t e^{c_t}
    kd = k * torch.exp(-cum)                   # e^{-c_{j+1}} k_j
    A = torch.einsum("bnthk,bnjhk->bnhtj", q, kd)
    tril = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=rh.device).tril(-1)
    A = A.masked_fill(~tril, 0.0)
    o_intra = torch.einsum("bnhtj,bnjhv->bnthv", A, v)
    o_diag = torch.einsum("bnthk,hk->bnth", r * k, u)[..., None] * v
    wC = torch.exp(cum[:, :, -1])              # (B,n,H,hs): e^{c_C}
    ks = k * torch.exp(cum[:, :, -1:] - cum)   # e^{c_C - c_{j+1}} k_j
    kv = torch.einsum("bnjhk,bnjhv->bnhkv", ks, v)
    S, starts = S0, []
    for i in range(n):
        starts.append(S)
        S = wC[:, i, ..., None] * S + kv[:, i]
    o_inter = torch.einsum("bnchk,bnhkv->bnchv", q, torch.stack(starts, 1))
    return S, (o_inter + o_intra + o_diag).reshape(b, s, h, hs)


def _wkv_per_token(rh, kh, vh, wh, u, S):
    """The per-token recurrence (the decode step, and a prefill whose
    length is no multiple of WKV_CHUNK). Returns (S_final, o (B,S,H,hs))."""
    outs = []
    for t in range(rh.shape[1]):
        kv = kh[:, t, :, :, None] * vh[:, t, :, None, :]    # (B,H,hs,hs)
        outs.append(torch.einsum("bhk,bhkv->bhv", rh[:, t],
                                 u[None, :, :, None] * kv + S))
        S = wh[:, t, ..., None] * S + kv
    return S, torch.stack(outs, 1)


def rwkv_defs(cfg: ModelConfig, name: str) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    lw, lm = cfg.rwkv_decay_lora, cfg.rwkv_mix_lora
    return {
        # token-shift mixing coefficients + LoRA
        "maa_x": ParamDef((d,), (None,), f"{name}.maa_x", "small"),
        "maa": ParamDef((5, d), (None, None), f"{name}.maa", "small"),
        "maa_w1": ParamDef((d, 5 * lm), (None, None), f"{name}.maa_w1", "small"),
        "maa_w2": ParamDef((5, lm, d), (None, None, None), f"{name}.maa_w2", "small"),
        # data-dependent decay
        "decay": ParamDef((d,), (None,), f"{name}.decay", "small"),
        "decay_w1": ParamDef((d, lw), (None, None), f"{name}.decay_w1", "small"),
        "decay_w2": ParamDef((lw, d), (None, None), f"{name}.decay_w2", "small"),
        "faaaa": ParamDef((cfg.n_rwkv_heads, cfg.rwkv_head_size),
                          (None, None), f"{name}.faaaa", "small"),
        "wr": ParamDef((d, d), ("tp", None), f"{name}.wr"),
        "wk": ParamDef((d, d), ("tp", None), f"{name}.wk"),
        "wv": ParamDef((d, d), ("tp", None), f"{name}.wv"),
        "wg": ParamDef((d, d), ("tp", None), f"{name}.wg"),
        "wo": ParamDef((d, d), (None, "tp"), f"{name}.wo"),
        "ln_x": ParamDef((d,), (None,), f"{name}.ln_x", "ones"),
        # channel mix
        "cm_maa_k": ParamDef((d,), (None,), f"{name}.cm_maa_k", "small"),
        "cm_maa_r": ParamDef((d,), (None,), f"{name}.cm_maa_r", "small"),
        "cm_wk": ParamDef((d, f), ("fsdp", "tp"), f"{name}.cm_wk"),
        "cm_wv": ParamDef((f, d), ("tp", "fsdp"), f"{name}.cm_wv"),
        "cm_wr": ParamDef((d, d), ("tp", None), f"{name}.cm_wr"),
    }


def _token_shift(x, shift_state):
    """x: (B,S,D); shift_state: (B,1,D), the previous segment's last token."""
    return torch.cat([shift_state.to(x.dtype), x[:, :-1]], dim=1)


def _mm(x, w, shd: Shardings, kinds: tuple):
    """x @ w as GSPMD runs the block's products on a mesh: x keeps its
    batch rows, and `kinds` are the logical kinds of w's two dims (the
    first also x's last). Under sequence parallelism (training) x stays
    on its sequence shard and w is gathered whole instead."""
    if shd.logical("seq"):
        seq = ("batch", "seq", None)
        return shd.local_with(torch.matmul, (x, w), (seq, (None, None)),
                              [(x.shape[:-1] + w.shape[-1:], seq)])
    return L._rows(x, shd, kinds[0]) @ shd.lay(w, *kinds)


def rwkv_time_mix(x, p, cfg: ModelConfig, state,
                  shd: Shardings = NO_SHARDING):
    """Returns (out, {"wkv", "shift_tm"}). The routes: chunked iff
    S > 1 and S % WKV_CHUNK == 0, else per token. On a mesh the
    products run as GSPMD runs them (`_mm`): in serving, the token-shift
    LoRA, the decay's first product and the input-dim-sharded
    projections contract over tp, the LoRA's mix comes out sharded on D
    over tp; wo's columns stay over tp (GSPMD gathers wo whole and
    computes all of it on each device); in training each runs on the
    sequence shard. r, k and v reach the recurrence's heads in the
    model's dtype."""
    b, s, d = x.shape
    h, hs = cfg.n_rwkv_heads, cfg.rwkv_head_size
    lm = cfg.rwkv_mix_lora
    acc = torch.promote_types(x.dtype, torch.float32)
    tp_in = ("tp", None)

    xx = _token_shift(x, state["shift_tm"]) - x
    xxx = x + xx * p["maa_x"].to(x.dtype)
    lora = torch.tanh(_mm(xxx, p["maa_w1"].to(x.dtype), shd,
                          tp_in))                             # (B,S,5*lm)
    lora = lora.reshape(b, s, 5, lm).permute(2, 0, 1, 3)      # (5,B,S,lm)
    mix = _lora_mix(lora, p["maa_w2"].to(x.dtype), shd)
    mix = mix + p["maa"].to(x.dtype)[:, None, None, :]
    xw, xk, xv, xr, xg = [x + xx * mix[i] for i in range(5)]

    r = _mm(xr, p["wr"].to(x.dtype), shd, tp_in)
    k = _mm(xk, p["wk"].to(x.dtype), shd, tp_in)
    v = _mm(xv, p["wv"].to(x.dtype), shd, tp_in)
    g = F.silu(_mm(xg, p["wg"].to(x.dtype), shd, tp_in))

    dec = p["decay"].to(acc) + _mm(
        torch.tanh(_mm(xw, p["decay_w1"].to(x.dtype), shd, tp_in)).to(acc),
        p["decay_w2"].to(acc), shd, (None, None))
    # per-token decay clamped to >= e^-8 on both routes: it keeps the
    # chunked form's exponents in range, and decode equal to the full
    # forward
    w = torch.exp(-torch.clamp(torch.exp(dec), max=8.0))     # [e^-8, 1)

    # local along batch and heads: on a mesh each device runs the
    # recurrence of its own rows (and heads, where tp divides them)
    heads = ("batch", None, "tp", None)
    rh, kh, vh = (shd.lay(t.reshape(b, s, h, hs), *heads).to(acc)
                  for t in (r, k, v))
    wh = w.reshape(b, s, h, hs)
    u = p["faaaa"].to(acc)
    S0 = state["wkv"].to(acc)
    if s > 1 and s % WKV_CHUNK == 0:
        route = lambda *a: _wkv_chunked(*a, WKV_CHUNK)
    else:
        route = _wkv_per_token
    S_final, o = shd.local_with(
        route, (rh, kh, vh, wh, u, S0),
        (heads, heads, heads, heads, ("tp", None),
         ("batch", "tp", None, None)),
        (((b, h, hs, hs), ("batch", "tp", None, None)),
         ((b, s, h, hs), heads)))

    # group norm over each head (ln_x), then the gate and the output
    # projection
    mu = o.mean(-1, keepdim=True)
    var = (o - mu).square().mean(-1, keepdim=True)
    o = (o - mu) * torch.rsqrt(var + 64e-5)
    o = o.reshape(b, s, d) * p["ln_x"].to(acc)
    out = shd.act(_mm(o.to(x.dtype) * g, p["wo"].to(x.dtype), shd,
                      (None, "tp")), "batch", "seq", None)
    return out, {"wkv": S_final, "shift_tm": x[:, -1:]}


def _lora_mix(lora, w2, shd: Shardings):
    """The token-shift LoRA's second product, (5,B,S,lm) x (5,lm,D): in
    serving its D over tp, in training on the sequence shard."""
    mix = lambda a, w: torch.einsum("fbsl,fld->fbsd", a, w)
    if shd.logical("seq"):
        seq = (None, "batch", "seq", None)
        return shd.local_with(mix, (lora, w2), (seq, (None, None, None)),
                              [(lora.shape[:-1] + w2.shape[-1:], seq)])
    return mix(shd.lay(lora, None, "batch", None, None),
               shd.lay(w2, None, None, "tp"))


def rwkv_channel_mix(x, p, cfg: ModelConfig, state,
                     shd: Shardings = NO_SHARDING):
    """Returns (out, {"shift_cm"}). On a mesh in serving, cm_wk's and
    cm_wv's ffn dim over tp and cm_wr's contraction over tp; where the
    rows do not split, cm_wk contracts over its FSDP shard and cm_wv's
    output is split over it (`Shardings.stationary`); in training each
    product runs on the sequence shard (`_mm`)."""
    c = shd.stationary(x.shape[0])
    xx = _token_shift(x, state["shift_cm"]) - x
    xk = x + xx * p["cm_maa_k"].to(x.dtype)
    xr = x + xx * p["cm_maa_r"].to(x.dtype)
    k = torch.square(F.relu(_mm(xk, p["cm_wk"].to(x.dtype), shd,
                                (c, "tp"))))
    kv = _mm(k, p["cm_wv"].to(x.dtype), shd, ("tp", c))
    r = torch.sigmoid(_mm(xr, p["cm_wr"].to(x.dtype), shd, ("tp", None)))
    return shd.act(r * kv, "batch", "seq", None), {"shift_cm": x[:, -1:]}


def rwkv_state_defs(cfg: ModelConfig, batch: int, name: str) -> dict:
    h, hs, d = cfg.n_rwkv_heads, cfg.rwkv_head_size, cfg.d_model
    return {
        "wkv": ParamDef((batch, h, hs, hs), ("batch", None, None, None),
                        f"{name}.wkv", "zeros"),
        "shift_tm": ParamDef((batch, 1, d), ("batch", None, None),
                             f"{name}.shift_tm", "zeros"),
        "shift_cm": ParamDef((batch, 1, d), ("batch", None, None),
                             f"{name}.shift_cm", "zeros"),
    }
