"""Plain reference of a decoder LM with dense or routed-MoE MLPs, in
float32 with TF32 off, from a configuration file and the benchmark's
weight tree.

It follows the configuration's published equations: RMSNorm, RoPE on
halves, grouped-query causal attention scaled by `attention_multiplier`
(default 1/sqrt(head_dim)), a SiLU-gated MLP or a softmax router with
top-k experts (normalised where `norm_topk_prob`), a shared expert under
a sigmoid gate, GShard capacity over the tokens of one prefill
(`moe_capacity_factor`; a token after the prefill drops nothing), and
the embedding, residual and logits multipliers. It imports nothing of
the program: no kernel, cache or batching; attention is computed
exactly in blocks of query rows.

It runs a layer at a time over a batch of sequences, each layer's
weights cast to float32 once, so that it fits beside the served model.
`precision="fp8"` is the control: every product's operands rounded to
float8 e4m3 (per-row scales), the nearest precision below the bfloat16
that the configuration states.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

ATTN_BLOCK = 1024          # query rows a block of the exact attention holds
FP8_MAX = 448.0            # largest finite float8 e4m3


@contextlib.contextmanager
def full_precision():
    """float32 products in float32: TF32 off for matmul and cuDNN."""
    mm, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn


class _Ops:
    """Products in the reference's precision: float32, or with each
    operand rounded to float8 e4m3 on per-row scales (the control)."""

    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.fp8 = precision == "fp8"

    def round(self, x, dim: int = -1):
        """x as the products read it: itself, or rounded to float8 with a
        scale per row along `dim`."""
        if not self.fp8:
            return x
        amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
        s = amax / FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s

    def mm(self, x, w):
        """x (..., K) @ w (K, N), operands rounded along K."""
        return self.round(x) @ self.round(w, dim=0)


def _rms(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, sin, cos):
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(h, p, c, s, ops, sin, cos):
    S = h.shape[0]
    H, KVH, hd = s["H"], s["KVH"], s["hd"]
    q = ops.mm(h, p["wq"].reshape(s["D"], H * hd)).view(S, H, hd)
    k = ops.mm(h, p["wk"].reshape(s["D"], KVH * hd)).view(S, KVH, hd)
    v = ops.mm(h, p["wv"].reshape(s["D"], KVH * hd)).view(S, KVH, hd)
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q, k = _rope(q, sin, cos), _rope(k, sin, cos)
    g = H // KVH
    k = ops.round(k.repeat_interleave(g, dim=1))
    v = ops.round(v.repeat_interleave(g, dim=1), dim=0)
    q = ops.round(q)
    scale = c.get("attention_multiplier") or 1.0 / math.sqrt(hd)
    out = torch.empty_like(q)
    for q0 in range(0, S, ATTN_BLOCK):
        q1 = min(q0 + ATTN_BLOCK, S)
        sc = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) * scale
        qpos = torch.arange(q0, q1, device=h.device)[:, None]
        kpos = torch.arange(q1, device=h.device)[None, :]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        pr = ops.round(torch.softmax(sc, dim=-1))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", pr, v[:q1])
    return ops.mm(out.reshape(S, H * hd), p["wo"].reshape(H * hd, s["D"]))


def _mlp(h, p, ops):
    return ops.mm(F.silu(ops.mm(h, p["wg"])) * ops.mm(h, p["wu"]), p["wd"])


def _moe(h, p, c, s, ops, prefilled: int):
    """The routed experts plus the shared expert. Tokens [0, prefilled)
    were one prefill: each expert takes at most its capacity of them, in
    token order; later tokens drop nothing."""
    S, E, k = h.shape[0], s["E"], s["k"]
    gates = torch.softmax(ops.mm(h, p["router"]), dim=-1)
    topw, topi = torch.topk(gates, k, dim=-1)                  # (S, k)
    if c.get("norm_topk_prob"):
        topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
    n = min(prefilled, S)
    if n:
        cap = max(int(c["moe_capacity_factor"] * k * n / E), 1)
        hits = F.one_hot(topi[:n], E).sum(1)                   # (n, E)
        before = torch.cumsum(hits, 0) - hits                  # earlier tokens
        pos = before.gather(1, topi[:n])                       # (n, k)
        topw = topw.clone()
        topw[:n] = topw[:n] * (pos < cap)
    out = torch.zeros_like(h)
    for e in range(E):
        tok, slot = torch.nonzero(topi == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        x = h[tok]
        y = ops.mm(F.silu(ops.mm(x, p["wg"][e])) * ops.mm(x, p["wu"][e]),
                   p["wd"][e])
        out.index_add_(0, tok, y * topw[tok, slot, None])
    if "shared" in p:
        gate = torch.sigmoid(ops.mm(h, p["shared_gate"]))
        out = out + gate * _mlp(h, p["shared"], ops)
    return out


def _layer(tree, i: int) -> dict:
    """Block i of a block-stacked tree, in float32."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i].float()
            for k, v in tree.items()}


def _dims(c: dict) -> dict:
    d, h = c["hidden_size"], c["num_attention_heads"]
    return {"D": d, "H": h, "KVH": c["num_key_value_heads"],
            "hd": int(c.get("head_dim") or d // h),
            "V": c["vocab_size"], "L": c["num_hidden_layers"],
            "E": int(c.get("num_experts") or c.get("num_local_experts") or 0),
            "k": int(c.get("num_experts_per_tok") or 0)}


def logits_at(c: dict, weights: dict, seqs, prefilled, starts,
              precision: str = "f32") -> list[torch.Tensor]:
    """float32 logits over the real vocabulary at positions
    [starts[i], len(seqs[i])) of each token sequence `seqs[i]` (1-D int64
    on the weights' device), whose first `prefilled[i]` tokens were one
    prefill."""
    s = _dims(c)
    ops = _Ops(precision)
    eps = float(c["rms_norm_eps"])
    res = float(c.get("residual_multiplier", 1.0))
    emb = weights["embed"]
    with torch.no_grad(), full_precision():
        xs = [emb[t].float() * float(c.get("embedding_multiplier", 1.0))
              for t in seqs]
        inv = 1.0 / (float(c["rope_theta"]) ** (
            torch.arange(0, s["hd"], 2, dtype=torch.float32,
                         device=emb.device) / s["hd"]))
        angles = [torch.arange(x.shape[0], dtype=torch.float32,
                               device=emb.device)[:, None] * inv
                  for x in xs]
        rope = [(a.sin()[:, None], a.cos()[:, None]) for a in angles]
        stacked = weights["layers"][0]
        for i in range(s["L"]):
            p = _layer(stacked, i)
            for j, x in enumerate(xs):
                h = _rms(x, p["ln1"]["scale"], eps)
                x = x + res * _attention(h, p["attn"], c, s, ops, *rope[j])
                h = _rms(x, p["ln2"]["scale"], eps)
                mlp = (_moe(h, p["mlp"], c, s, ops, prefilled[j]) if s["E"]
                       else _mlp(h, p["mlp"], ops))
                xs[j] = x + res * mlp
            del p
        unembed = weights.get("unembed", emb)[:s["V"]].float()
        final = weights["final_norm"]["scale"].float()
        out = []
        for j, x in enumerate(xs):
            h = _rms(x[starts[j]:], final, eps)
            out.append(ops.mm(h, unembed.t())
                       / float(c.get("logits_scaling", 1.0)))
            xs[j] = None
        return out
