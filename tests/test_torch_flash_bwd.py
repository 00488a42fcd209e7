"""The gradient of the port's flash attention on the CPU: the plain
backward `ref.flash_attention_bwd` (explicit formulas, not autograd)
against autograd of `ref.flash_attention` in f64 and against `jax.grad`
of the reference's `_plain_attention`; the forward's log-sum-exp against
`jax.nn.logsumexp`; the autograd Function of `ops.flash_attention` on CPU
tensors (its CPU primitives), the cases it refuses, and
`ops.decode_attention` refusing a gradient; the chunked pure
`layers.flash_attention` against the reference's.

The cases are those of chip_smoke.py phase 17 (a) at small sizes:
granite's causal GQA, a causal window, whisper's unmasked encoder and its
cross-attention (Sq != Skv), a ragged Sq. Tolerances: f64 against f64 at
1e-10 of the output's scale (the same arithmetic in another order); f32
against the reference at 1e-5 of scale (f32 sums in other orders, over at
most 96 keys).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED
from repro.models import Shardings
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import flash_attention_bwd as kfb
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as TL
from repro_torch.configs import REDUCED as T_REDUCED

# (B, Sq, Skv, H, KVH, hd, causal, window)
CASES = {
    "granite-causal-gqa": (2, 64, 64, 8, 2, 32, True, 0),
    "causal-window": (1, 96, 96, 4, 2, 16, True, 16),
    "whisper-encoder": (2, 75, 75, 3, 3, 16, False, 0),
    "whisper-cross": (2, 22, 75, 3, 3, 16, False, 0),
    "ragged": (1, 37, 37, 4, 1, 24, True, 0),
}
IDS = list(CASES)


def _inputs(case, dtype, seed=0):
    b, sq, skv, h, kvh, hd, _, _ = case
    rng = np.random.default_rng(seed)
    arr = lambda *s: rng.normal(size=s)
    q, k, v = arr(b, sq, h, hd), arr(b, skv, kvh, hd), arr(b, skv, kvh, hd)
    do = arr(b, sq, h, hd)
    return [torch.from_numpy(a).to(dtype) for a in (q, k, v, do)]


def _close(got, want, tol):
    got, want = got.double(), torch.as_tensor(np.array(want)).double()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * scale, f"max err {err:.3g} > {tol} x {scale:.3g}"


@pytest.mark.parametrize("name", IDS)
def test_plain_backward_matches_autograd_f64(name):
    *_, causal, window = CASES[name]
    q, k, v, do = _inputs(CASES[name], torch.float64)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(ref.flash_attention(q, k, v, causal, window),
                               (q, k, v), do)
    with torch.no_grad():
        out, lse = ref.flash_attention(q, k, v, causal, window,
                                       return_lse=True)
        got = ref.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64
        _close(g, w, 1e-10)


def _jax_attention(case):
    *_, causal, window = case
    cfg = dataclasses.replace(REDUCED["granite-3-8b"], sliding_window=window)
    return lambda q, k, v: JT._plain_attention(q, k, v, cfg, causal)


@pytest.mark.parametrize("name", IDS)
def test_plain_backward_matches_jax_grad(name):
    case = CASES[name]
    *_, causal, window = case
    q, k, v, do = _inputs(case, torch.float32)
    fn = _jax_attention(case)
    j = [jnp.asarray(t.numpy()) for t in (q, k, v, do)]
    _, vjp = jax.vjp(fn, *j[:3])
    want = vjp(j[3])
    out, lse = ref.flash_attention(q, k, v, causal, window, return_lse=True)
    got = ref.flash_attention_bwd(q, k, v, out, lse, do, causal, window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, 1e-5)
    _close(out, fn(*j[:3]), 1e-5)


@pytest.mark.parametrize("name", IDS)
def test_lse_matches_jax_logsumexp(name):
    b, sq, skv, h, kvh, hd, causal, window = CASES[name]
    q, k, _, _ = _inputs(CASES[name], torch.float32)
    _, lse = ref.flash_attention(q, k, k, causal, window, return_lse=True)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    qj = jnp.asarray(q.numpy())
    kj = jnp.repeat(jnp.asarray(k.numpy()), h // kvh, axis=2)
    s = jnp.einsum("bqhd,bkhd->bhqk", qj, kj) / np.sqrt(hd)
    qp, kp = jnp.arange(sq)[:, None], jnp.arange(skv)[None, :]
    mask = jnp.ones((sq, skv), bool)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, s, -1e30), axis=-1))
    err = np.abs(lse.numpy() - want)
    assert (err <= 1e-5 * (1 + np.abs(want))).all(), float(err.max())


@pytest.mark.parametrize("name", IDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_runs_the_plain_primitives_on_the_cpu(name, dtype):
    """ops.flash_attention with inputs that need a gradient: the forward
    equals the plain forward, the gradients equal ref.flash_attention_bwd
    on the saved output and log-sum-exp, bit for bit, and no kernel
    launches."""
    *_, causal, window = CASES[name]
    q, k, v, do = _inputs(CASES[name], dtype)
    before = (kfa.KERNEL.launches, kfb.KERNEL.launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, causal, window)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    want_out, lse = ref.flash_attention(q, k, v, causal, window,
                                        return_lse=True)
    assert torch.equal(out.detach(), want_out)
    want = ref.flash_attention_bwd(q, k, v, want_out, lse, do, causal,
                                   window)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        assert torch.equal(g, w)
    assert (kfa.KERNEL.launches, kfb.KERNEL.launches) == before


def test_no_grad_path_is_the_plain_forward():
    """Without a gradient asked, the call is the plain forward itself (no
    Function, no log-sum-exp)."""
    q, k, v, _ = _inputs(CASES["granite-causal-gqa"], torch.float32)
    out = ops.flash_attention(q, k, v)
    assert out.grad_fn is None
    assert torch.equal(out, ref.flash_attention(q, k, v))


def test_backward_refuses_what_training_never_reaches():
    q, k, v, _ = _inputs(CASES["granite-causal-gqa"], torch.float32)
    q.requires_grad_()
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, q_offset=3)
    with pytest.raises(ValueError, match="see no key"):
        ops.flash_attention(q, k[:, :8], v[:, :8], window=4)
    with torch.no_grad():          # no gradient asked: the forward runs
        ops.flash_attention(q, k, v, q_offset=3)
    with pytest.raises(ValueError, match="head_dim"):
        kfb.check_supported(8, 8, 320, 0, 0)


def test_decode_attention_refuses_a_gradient():
    q = torch.randn(2, 4, 16, requires_grad=True)
    k = torch.randn(2, 8, 2, 16)
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.decode_attention(q, k, k, 8)
    with torch.no_grad():
        ops.decode_attention(q, k, k, 8)
    assert kda.KERNEL.launches == 0


def test_backward_kernel_needs_cuda_tensors():
    q, k, v, do = _inputs(CASES["granite-causal-gqa"], torch.float32)
    out, lse = ref.flash_attention(q, k, v, return_lse=True)
    with pytest.raises(ValueError, match="CUDA"):
        kfb.flash_attention_bwd(q, k, v, out, lse, do)
    with pytest.raises(ValueError, match="CUDA"):
        kfa.flash_attention(q, k, v, return_lse=True)
    assert kfb.KERNEL.launches == 0


# (Sq, Skv, H, KVH, hd, causal, window, q_offset, q_chunk, kv_chunk)
CHUNKED = [
    (32, 32, 4, 2, 16, True, 0, 0, 8, 8),
    (32, 32, 4, 2, 16, True, 6, 0, 8, 16),
    (24, 40, 4, 4, 16, False, 0, 0, 8, 8),
    (16, 48, 4, 1, 8, True, 0, 32, 8, 16),
    (16, 16, 2, 2, 32, True, 0, 0, 64, 64),     # chunks wider than S
]


@pytest.mark.parametrize("case", CHUNKED, ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_flash_attention_matches_reference(case, dtype):
    sq, skv, h, kvh, hd, causal, window, off, qc, kc = case
    cfg = dataclasses.replace(REDUCED["granite-3-8b"], q_chunk=qc,
                              kv_chunk=kc, sliding_window=window)
    tcfg = dataclasses.replace(T_REDUCED["granite-3-8b"], q_chunk=qc,
                               kv_chunk=kc, sliding_window=window)
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((2, sq, h, hd), (2, skv, kvh, hd), (2, skv, kvh, hd)))
    jdt = jnp.dtype(dtype)
    want = JL.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)), cfg,
                              Shardings(None), causal=causal, q_offset=off)
    tdt = getattr(torch, dtype)
    got = TL.flash_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                             tcfg, causal=causal, q_offset=off)
    assert got.dtype == tdt and got.shape == (2, sq, h, hd)
    _close(got.float(), np.asarray(want, np.float32),
           1e-5 if dtype == "float32" else 1e-2)
    if dtype == "float32":
        _close(got, ref.flash_attention(*(torch.from_numpy(a)
                                          for a in (q, k, v)),
                                        causal, window, off), 1e-5)


def test_chunked_flash_attention_refuses_ragged_chunks():
    tcfg = dataclasses.replace(T_REDUCED["granite-3-8b"], q_chunk=8,
                               kv_chunk=8)
    x = torch.zeros(1, 12, 2, 8)
    with pytest.raises(ValueError, match="multiples"):
        TL.flash_attention(x, x, x, tcfg)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 64, "tensor_core"),      # whisper
    (torch.bfloat16, 128, "tensor_core"),     # granite and the rest
    (torch.bfloat16, 16, "tensor_core"),
    (torch.float32, 128, "cuda_core"),        # f32 held to f64 at 1e-4
    (torch.float32, 64, "cuda_core"),
    (torch.bfloat16, 72, "cuda_core"),        # not a multiple of 16
    (torch.bfloat16, 256, "cuda_core"),       # above TC_MAX_HEAD_DIM
], ids=str)
def test_backward_route(dtype, hd, want):
    assert kfb.route(dtype, hd) == want
    assert want in kfb.ROUTES


def test_backward_refuses_other_dtypes():
    """The wrapper's checks raise before the device check, on the CPU
    too: f16 (read as f32 it would be garbage), mixed dtypes."""
    q, k, v, do = _inputs(CASES["granite-causal-gqa"], torch.float16)
    out = torch.zeros_like(q)
    lse = torch.zeros(q.shape[0], q.shape[2], q.shape[1])
    with pytest.raises(ValueError, match="f32 or bf16"):
        kfb.flash_attention_bwd(q, k, v, out, lse, do)
    with pytest.raises(ValueError, match="one dtype"):
        kfb.flash_attention_bwd(q.float(), k, v, out, lse, do)
    assert kfb.KERNEL.launches == 0


# --------------------------------------------------------------------- #
# the tensor-core route's rounding points, rehearsed in f32
# --------------------------------------------------------------------- #

def _bf16(x):
    """x rounded to bf16, kept as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _tensor_core_grads(q, k, v, out, lse, do, causal, window,
                       operands="bf16", dtype=torch.float32):
    """The tensor-core route's arithmetic in `dtype`: q, k, v, dO, O as the
    kernel reads them (bf16 values); S and dP as sums of exact products;
    P = exp2(S scale log2 e - L log2 e) and dS = P (dP - D), D =
    rowsum(dO o O); P and dS as the operands of dV = P^T dO,
    dK = dS^T Q / sqrt(hd), dQ = dS K / sqrt(hd): rounded to bf16
    (`operands` "bf16"), split into bf16 hi + lo ("split", mma_bf16.cuh's
    split_bf16) or kept ("exact"). Gradients unrounded, GQA's group
    summed."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    q, k, v, do, out = (t.to(dtype) for t in (q, k, v, do, out))
    kw, vw = (torch.repeat_interleave(t, g, dim=2) for t in (k, v))
    log2e = 1.4426950408889634
    scale = 1.0 / np.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kw)
    qp, kp = torch.arange(sq)[:, None], torch.arange(skv)[None, :]
    mask = torch.ones(sq, skv, dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    l2 = (lse.to(torch.float32) * np.float32(log2e)).to(dtype)
    p = torch.exp2(s * (scale * log2e) - l2[..., None]).masked_fill(~mask, 0)
    d = (do * out).sum(-1).transpose(1, 2)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, vw)
    ds = p * (dp - d[..., None])

    def operand(x):
        if operands == "exact":
            return x
        hi = _bf16(x.float())
        return (hi + _bf16(x.float() - hi) if operands == "split"
                else hi).to(dtype)
    p_op, ds_op = operand(p), operand(ds)
    dv = torch.einsum("bhqk,bqhd->bkhd", p_op, do)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds_op, kw) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds_op, q) * scale
    dk = dk.reshape(b, skv, kvh, g, hd).sum(3)
    dv = dv.reshape(b, skv, kvh, g, hd).sum(3)
    return dq, dk, dv


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


# granite's causal GQA and whisper's unmasked attention at small sizes,
# with q scaled so that scores reach the hundreds (chip_smoke.py phase 17
# (a)'s second case), and at unit scale
REHEARSAL = {
    "granite-scores-in-the-hundreds": (1, 96, 96, 4, 2, 64, True, 0, 40.0),
    "granite-causal-gqa": (2, 64, 64, 8, 2, 32, True, 0, 1.0),
    "causal-window": (1, 96, 96, 4, 2, 16, True, 16, 1.0),
    "whisper-cross": (2, 22, 75, 3, 3, 16, False, 0, 1.0),
}


def _rehearsal_inputs(name):
    *case, qscale = REHEARSAL[name]
    q, k, v, do = _inputs(case, torch.float32, seed=7)
    return _bf16(q * qscale), _bf16(k), _bf16(v), _bf16(do), *case[6:]


@pytest.mark.parametrize("name", list(REHEARSAL))
def test_tensor_core_rounding_within_the_bf16_band(name):
    """The route's rounding points (bf16 inputs, O, P and dS operands, f32
    sums, bf16 gradients) stay within chip_smoke.py's BWD_BAND[bf16] (1e-2
    of scale) of the f64 plain version on the same bf16 inputs: the band
    phase 17 (a) holds the kernel to. Measured here 2.2e-3 to 7.7e-3, the
    plain bf16 version 1.3e-3 to 7.7e-3: O's bf16 rounding (through D)
    and the gradients' own dominate, the operands' adds ~2e-3."""
    import chip_smoke
    q, k, v, do, causal, window = _rehearsal_inputs(name)
    out, lse = ref.flash_attention(q, k, v, causal, window, return_lse=True)
    got = _tensor_core_grads(q, k, v, _bf16(out), lse, do, causal, window)
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, do))
    o64, l64 = ref.flash_attention(q64, k64, v64, causal, window,
                                   return_lse=True)
    want = ref.flash_attention_bwd(q64, k64, v64, o64, l64, do64, causal,
                                   window)
    band = chip_smoke.BWD_BAND[torch.bfloat16]
    for which, g, w in zip(("dq", "dk", "dv"), got, want):
        err = _rel(_bf16(g), w)           # the kernel writes bf16
        assert err <= band, f"{which} {err:.3g} of scale > {band}"


@pytest.mark.parametrize("name", list(REHEARSAL))
def test_tensor_core_split_operands_within_1e4(name):
    """With P and dS split into bf16 hi + lo (the forward's remedy for P)
    the operands keep about 16 bits: unrounded gradients within 1e-4 of
    scale of the same formulas in f64 on the same O and L (what is left
    is f32 sums over at most 96 keys and the f32 exponent, ~1e-6), and
    closer than with plain bf16 operands (8 bits, ~1e-3)."""
    q, k, v, do, causal, window = _rehearsal_inputs(name)
    out, lse = ref.flash_attention(q, k, v, causal, window, return_lse=True)
    args = (q, k, v, _bf16(out), lse, do, causal, window)
    want = _tensor_core_grads(*args, operands="exact", dtype=torch.float64)
    split = _tensor_core_grads(*args, operands="split")
    plain = _tensor_core_grads(*args, operands="bf16")
    for which, s, p, w in zip(("dq", "dk", "dv"), split, plain, want):
        err_s, err_p = _rel(s, w), _rel(p, w)
        assert err_s <= 1e-4, f"{which} split {err_s:.3g} of scale"
        assert err_s < err_p, f"{which} split {err_s:.3g}, plain {err_p:.3g}"
