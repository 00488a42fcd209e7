"""The arithmetic of the two attention kernels' designs, and their
host-side choosers. These tests check the designs, not the CUDA kernels:
plain-PyTorch emulations of the order in which `csrc/decode_attention.cu`
combines its partial softmax states (8 rows a warp per 32-row tile, the
warps merged in warp order, the splits of the cache in split order) and
of the numerics of `csrc/flash_attention.cu`'s tensor-core route (bf16
Q/K/V, f32 scores, P split into bf16(P) and bf16(P - bf16(P)) for two
products with V, f32 sums) are held to
the reference's Pallas kernels in interpret mode and its `kernels/ref.py`;
`decode_attention.split_count` and `flash_attention.route` are the port's
own. The CUDA kernels are held to the port's plain versions on the card
by chip_smoke.py: phase 3 on random inputs, phase 4 on the model's
activations.

Tolerances are tests/test_kernels.py's: 1e-4 at f32, 3e-2 for flash at
bf16; and, for the flash emulation against the port's plain version,
chip_smoke.py's bf16 band |got - want| <= 1e-2 (1 + |want|)."""

import functools
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.configs import ARCHS, REDUCED
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref

ROOT = Path(__file__).resolve().parents[1]
LOG2E = math.log2(math.e)
EMPTY_M = -1e30
TILE_ROWS = 32          # decode: cache rows a block stages at a time
BQ = BK = 64            # flash: query rows a block, keys a tile


def _inputs(seed, dtype, *shapes):
    rng = np.random.default_rng(seed)
    js = [jnp.asarray(rng.normal(size=s).astype(np.float32), dtype)
          for s in shapes]
    ts = [bridge.tensor_from_numpy(np.asarray(a), "cpu") for a in js]
    return js, ts


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# --------------------------------------------------------------------- #
# decode: split the W slots, merge the partial states
# --------------------------------------------------------------------- #

def _online(qs, k, v, groups):
    """(m, l, acc) of an online softmax in base 2 over the row groups
    (r0, r1) of k and v, one group after another; (-1e30, 0, 0) if none."""
    m = torch.full(qs.shape[:2], EMPTY_M)
    l = torch.zeros(qs.shape[:2])
    acc = torch.zeros(qs.shape)
    for r0, r1 in groups:
        sc = torch.einsum("kgd,rkd->kgr", qs, k[r0:r1].float())
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] \
            + torch.einsum("kgr,rkd->kgd", p, v[r0:r1].float())
        m = m_new
    return m, l, acc


def _merge(states, dim=0):
    """Partial states stacked along `dim`, weighted by exp2(m - max m)."""
    m, l, acc = (torch.stack(x, dim) for x in zip(*states))
    mx = m.amax(dim, keepdim=True)
    f = torch.exp2(m - mx)
    return mx.squeeze(dim), (l * f).sum(dim), (acc * f[..., None]).sum(dim)


def split_merge_decode(q, k, v, lengths, splits):
    """What the decode kernel computes: per (row, KV head, split), each of
    4 warps takes 8 rows of every 32-row tile of the split's valid rows
    into its online softmax, and the warps merge in warp order; a split
    that starts at or past lengths[b] gives the empty state (-1e30, 0, 0);
    then the splits merge in split order. Returns (out, m, l, acc), the
    splits' states as (B, KVH, G, S[, hd])."""
    b, h, hd = q.shape
    w, kvh = k.shape[1], k.shape[2]
    chunk = -(-w // splits)
    qs = q.float().reshape(b, kvh, h // kvh, hd) * (LOG2E / math.sqrt(hd))
    rows = []
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), w)
        states = []
        for s in range(splits):
            lo, hi = s * chunk, min(s * chunk + chunk, n)
            warps = [_online(qs[bi], k[bi], v[bi], [
                (t + 8 * i, min(t + 8 * i + 8, hi))
                for t in range(lo, hi, TILE_ROWS) if t + 8 * i < hi])
                for i in range(TILE_ROWS // 8)]
            states.append(_merge(warps))
        rows.append([torch.stack(x, -1) for x in zip(*states)])
    m, l, acc = (torch.stack(x) for x in zip(*rows))
    acc = acc.movedim(-1, -2)                    # (B, KVH, G, S, hd)
    _, den, num = _merge([(m[..., i], l[..., i], acc[..., i, :])
                          for i in range(splits)])
    out = num / den.clamp_min(1e-30)[..., None]
    return out.reshape(b, h, hd).to(q.dtype), m, l, acc


W = 100


@functools.lru_cache(maxsize=None)
def _decode_oracles(n):
    """The reference's decode at one valid length n (its Pallas contract:
    one length for the batch): (port inputs, oracle, Pallas kernel)."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        30, jnp.float32, (1, 8, 32), (1, W, 2, 32), (1, W, 2, 32))
    return ((qt, kt, vt), np.asarray(jref.decode_attention(qj, kj, vj, n)),
            np.asarray(jops.decode_attention(qj, kj, vj, jnp.int32(n),
                                             interpret=True)))


@pytest.mark.parametrize("splits", [1, 2, 8, 16])
def test_decode_split_merge_matches_reference(splits):
    chunk = -(-W // splits)
    lengths = sorted({max(1, min(W, n))
                      for n in (1, chunk - 1, chunk, chunk + 1, W)})
    (qt, kt, vt), _, _ = _decode_oracles(W)
    b = len(lengths)
    q, k, v = qt.expand(b, -1, -1), kt.expand(b, -1, -1, -1), \
        vt.expand(b, -1, -1, -1)
    lens = torch.tensor(lengths, dtype=torch.int32)
    out, m, l, acc = split_merge_decode(q, k, v, lens, splits)
    for t in (out, m, l, acc):
        assert torch.isfinite(t).all()
    for i, n in enumerate(lengths):
        _, want, pallas = _decode_oracles(n)
        _close(out[i:i + 1], want, 1e-4)
        _close(out[i:i + 1], pallas, 1e-4)
        for s in range(splits):          # splits wholly past the length
            if s * chunk >= n:
                assert (m[i, ..., s] == EMPTY_M).all()
                assert (l[i, ..., s] == 0).all()
                assert (acc[i, :, :, s] == 0).all()
    _close(out, ref.decode_attention(q, k, v, lens).numpy(), 1e-4)


def test_decode_split_merge_all_splits_empty_is_zero():
    """lengths 0 (outside the precondition, clamped): every split is
    empty, the merge divides 0 by max(0, 1e-30) and gives zeros, no NaN."""
    (qt, kt, vt), _, _ = _decode_oracles(W)
    out, m, l, _ = split_merge_decode(qt, kt, vt, torch.zeros(1), 8)
    assert (m == EMPTY_M).all() and (l == 0).all()
    assert torch.equal(out, torch.zeros_like(out))


def test_split_count_on_the_serving_path():
    """B 4, KVH 8, W 2048 on 132 SMs: 16 splits of 128 slots, 512 blocks."""
    s = kda.split_count(4, 8, 2048, 132)
    assert s == 16 and -(-2048 // s) == kda.MAX_CHUNK
    assert 4 * 8 * s >= 2 * 132


@pytest.mark.parametrize("b,kvh", [(1, 1), (1, 8), (2, 4), (4, 8), (64, 8),
                                   (300, 1)])
@pytest.mark.parametrize("w", [1, 7, 100, 129, 2048, 4096])
def test_split_count_rule(b, kvh, w):
    """The fewest splits with >= 2 blocks per SM and chunks of at most
    MAX_CHUNK slots; never more than W (a slot per split)."""
    sms = kda.SM_COUNT

    def fits(s):
        return b * kvh * s >= 2 * sms and -(-w // s) <= kda.MAX_CHUNK

    s = kda.split_count(b, kvh, w, sms)
    assert 1 <= s <= w
    assert fits(s) or s == w
    assert s == 1 or not fits(s - 1)
    assert kda.split_count(b, kvh, w, 66) <= s      # fewer SMs, no more


def test_graph_capture_holds_launches_for_its_replays():
    """Launches counted while a CUDA graph is captured (which runs none)
    are held for the graph, and each replay credits them; counts outside
    the capture go to the counters as before."""
    from repro_torch.kernels import _build
    counter = _build.LaunchCounter()
    counter.count("a")
    with _build.hold_launches() as held:
        counter.count("a", 3)
        counter.count()
    assert counter.launches == 1 and counter.route_launches == {"a": 1}
    for _ in range(2):
        held.credit()
    assert counter.launches == 9 and counter.route_launches == {"a": 7}


def test_workspaces_of_a_stream():
    """The workspaces a graph captured on a stream holds: that stream's,
    of every device, and no other's."""
    made = [kda.workspace(8, torch.device("cpu"), s) for s in (-5, -6)]
    try:
        assert [w is made[0] for w in kda.workspaces(-5)] == [True]
        assert kda.workspaces(-7) == []
    finally:
        for s in (-5, -6):
            kda._WORKSPACES.pop((None, s))


def test_graph_capture_holds_launches_and_keeps_buffers():
    """`kernels.graph_capture` on a stream: the launches counted inside
    are held for the graph's replays, and on exit it keeps the decode
    kernel's workspace of that stream, which the graph reads."""
    from repro_torch.kernels import graph_capture
    ws = kda.workspace(8, torch.device("cpu"), -5)
    before = kda.KERNEL.launches
    try:
        with graph_capture(types.SimpleNamespace(cuda_stream=-5)) as held:
            kda.KERNEL.count()
        assert kda.KERNEL.launches == before
        assert [w is ws for w in held.keep] == [True]
        held.credit()
        assert kda.KERNEL.launches == before + 1
    finally:
        kda._WORKSPACES.pop((None, -5))


# --------------------------------------------------------------------- #
# flash: the tensor-core route's numerics
# --------------------------------------------------------------------- #

def tensor_core_flash(q, k, v, causal=True, window=0, q_offset=0):
    """What the tensor-core kernel computes for bf16 q/k/v, walked as the
    kernel walks it: query tiles of 64 rows, each over its key-tile range
    [kt_begin, kt_end) (the tiles its positions q_offset + row can see),
    warps of 16 rows skipping the tiles none of their rows sees. Per
    64-key tile: raw scores S = Q.K^T in f32 (products of bf16 values are
    exact in f32), masks, the running max m of raw scores, p = exp2(S c -
    m c) with c = log2(e) / sqrt(hd) in f32, l += sum p in f32, P split
    into hi = bf16(P) and lo = bf16(P - hi), O = O alpha + hi.V + lo.V in
    f32; O / l in bf16. Rows from q_empty = Skv + window - 1 - q_offset
    on see no key: the main kernel skips them (whole tiles too) and the
    empty-row kernel writes the f32 mean of V, as the plain version gives
    them."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(h // kvh, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(h // kvh, dim=2).transpose(1, 2)
    qf = q.float().transpose(1, 2)                    # (B, H, Sq, hd)
    c = torch.tensor(LOG2E / math.sqrt(hd), dtype=torch.float32)
    out = torch.full((b, h, sq, hd), math.nan)
    q_empty = skv + window - 1 - q_offset if window else sq
    for q_lo in range(0, sq, BQ):
        if q_lo >= q_empty:
            continue
        p_lo = q_offset + q_lo
        kt_end = -(-skv // BK)
        if causal:
            kt_end = min(kt_end, (p_lo + BQ - 1) // BK + 1)
        kt_begin = (p_lo - window + 1) // BK \
            if window and p_lo - window + 1 > 0 else 0
        for wq_lo in range(q_lo, min(q_lo + BQ, sq), 16):
            rows = slice(wq_lo, min(wq_lo + 16, sq))
            wp_lo = q_offset + wq_lo
            qp = torch.arange(wp_lo, wp_lo + 16)[:rows.stop - wq_lo, None]
            m = torch.full((b, h, qp.shape[0]), EMPTY_M)
            l = torch.zeros(b, h, qp.shape[0])
            acc = torch.zeros(b, h, qp.shape[0], hd)
            for kt in range(kt_begin, kt_end):
                k_lo = kt * BK
                if (causal and wp_lo + 15 < k_lo) or \
                        (window and wp_lo - (k_lo + BK - 1) >= window):
                    continue                  # no row of the warp sees it
                kp = torch.arange(k_lo, min(k_lo + BK, skv))[None, :]
                s = qf[:, :, rows] @ kf[:, :, k_lo:k_lo + BK].transpose(-1, -2)
                ok = torch.ones(qp.shape[0], kp.shape[1], dtype=torch.bool)
                if causal:
                    ok &= qp >= kp
                if window:
                    ok &= qp - kp < window
                s = s.masked_fill(~ok, -math.inf)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp2((m - m_new) * c)
                p = torch.exp2(s * c - (m_new * c)[..., None])
                l = l * alpha + p.sum(-1)
                hi = p.bfloat16().float()
                lo = (p - hi).bfloat16().float()
                vt = vf[:, :, k_lo:k_lo + BK]
                acc = acc * alpha[..., None] + hi @ vt + lo @ vt
                m = m_new
            out[:, :, rows] = acc / l.clamp_min(1e-30)[..., None]
    if window and sq > q_empty:
        mean = v.float().mean(dim=1).repeat_interleave(h // kvh, dim=1)
        out[:, :, max(q_empty, 0):] = mean[:, :, None]
    assert not out.isnan().any()                  # every row written
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,window", [
    (1, 300, 300, 4, 2, 64, True, 0),     # GQA, causal, ragged seq
    (1, 512, 512, 2, 2, 128, True, 64),   # sliding window
    (1, 256, 700, 4, 1, 64, False, 0),    # cross-attention-like, ragged kv
    (1, 128, 512, 2, 2, 64, True, 32),    # window smaller than a kv tile
    # rows 19..39 see no key and get the mean of V, as the plain version
    # and the reference oracle give them
    (2, 40, 16, 4, 2, 16, True, 4),
])
def test_tensor_core_flash_numerics(b, sq, skv, h, kvh, hd, causal, window):
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        20, jnp.bfloat16, (b, sq, h, hd), (b, skv, kvh, hd),
        (b, skv, kvh, hd))
    got = tensor_core_flash(qt, kt, vt, causal, window)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    if sq <= skv + window - 1 or not window:   # Pallas needs a key a row
        _close(got, jops.flash_attention(qj, kj, vj, causal=causal,
                                         window=window, interpret=True), 3e-2)
    _close(got, jref.flash_attention(qj, kj, vj, causal=causal,
                                     window=window), 3e-2)
    want = ref.flash_attention(qt, kt, vt, causal, window).float()
    err = (got.float() - want).abs()
    assert (err <= 1e-2 * (1 + want.abs())).all(), float(err.max())


def _chunk_attention(q, k, v, q_pos, k_pos, window):
    """The reference's chunked-prefill attention stage
    (`DispatchPrefillStep._attn_fn`): causal (and window) masks on the
    explicit absolute query and key positions."""
    from repro.serve.dispatch_engine import DispatchPrefillStep
    stage = types.SimpleNamespace(
        cfg=types.SimpleNamespace(sliding_window=window))
    return DispatchPrefillStep._attn_fn(stage, q, k, v, jnp.asarray(q_pos),
                                        jnp.asarray(k_pos))


@pytest.mark.parametrize("sq,skv,h,kvh,hd,window,q_offset", [
    (64, 192, 4, 2, 64, 0, 128),     # the third 64-token chunk of a prompt
    (100, 260, 2, 2, 64, 0, 160),    # ragged chunk, causal tile cut mid-tile
    (40, 100, 4, 2, 32, 50, 60),     # banded prefix: keys start past 0
    (64, 256, 2, 1, 64, 32, 192),    # window: key tiles 0-1 wholly dead
    (80, 200, 2, 2, 16, 40, 120),    # window crossing a query-tile edge
    (24, 16, 4, 2, 16, 8, 20),       # rows 3.. see no key
    (16, 16, 2, 2, 16, 4, 40),       # no row sees a key: all mean of V
])
def test_tensor_core_flash_q_offset(sq, skv, h, kvh, hd, window, q_offset):
    """A chunk's queries at positions q_offset.. over keys at 0..: the
    kernel's tile ranges, warp skips and empty-row rule at offsets, held
    to the port's plain version with `q_offset` and to the reference's
    chunk attention on the same positions."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        21, jnp.bfloat16, (1, sq, h, hd), (1, skv, kvh, hd),
        (1, skv, kvh, hd))
    got = tensor_core_flash(qt, kt, vt, True, window, q_offset)
    assert torch.isfinite(got.float()).all()
    want = ref.flash_attention(qt, kt, vt, True, window, q_offset).float()
    err = (got.float() - want).abs()
    assert (err <= 1e-2 * (1 + want.abs())).all(), float(err.max())
    q_pos = np.arange(q_offset, q_offset + sq, dtype=np.int32)
    k_pos = np.arange(skv, dtype=np.int32)
    _close(got, _chunk_attention(qj, kj, vj, q_pos, k_pos, window), 3e-2)
    # the plain version at f32 against the reference's stage at f32
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        22, jnp.float32, (1, sq, h, hd), (1, skv, kvh, hd),
        (1, skv, kvh, hd))
    _close(ref.flash_attention(qt, kt, vt, True, window, q_offset),
           _chunk_attention(qj, kj, vj, q_pos, k_pos, window), 1e-4)


def test_flash_q_offset_zero_is_the_default():
    """q_offset = 0 is the call without it, bit for bit, and a negative
    offset is refused."""
    _, (qt, kt, vt) = _inputs(23, jnp.float32, (2, 70, 4, 16),
                              (2, 70, 2, 16), (2, 70, 2, 16))
    for window in (0, 9):
        assert torch.equal(ref.flash_attention(qt, kt, vt, True, window, 0),
                           ref.flash_attention(qt, kt, vt, True, window))
        assert torch.equal(tensor_core_flash(qt.bfloat16(), kt.bfloat16(),
                                             vt.bfloat16(), True, window, 0),
                           tensor_core_flash(qt.bfloat16(), kt.bfloat16(),
                                             vt.bfloat16(), True, window))
    with pytest.raises(ValueError, match="q_offset"):
        kops.flash_attention(qt, kt, vt, q_offset=-1)


# --------------------------------------------------------------------- #
# flash: the route
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("hd", [16, 32, 48, 64, 128, 144, 256,
                                8, 24, 72, 100, 264])
def test_flash_route(hd):
    """bf16 with hd a multiple of 16 up to 256 on the tensor cores; other
    bf16 head dims and every f32 call on CUDA cores."""
    tc = hd % 16 == 0 and hd <= 256
    assert kfa.route(torch.bfloat16, hd) == ("tensor_core" if tc
                                             else "cuda_core")
    assert kfa.route(torch.float32, hd) == "cuda_core"


def test_every_config_prefills_on_tensor_cores():
    """bf16 prefill of every config the port has (full and REDUCED)."""
    for cfg in list(ARCHS.values()) + list(REDUCED.values()):
        assert kfa.route(getattr(torch, cfg.dtype), cfg.hd) == "tensor_core"


def test_route_imports_no_cuda():
    """Choosing a route builds, loads and initialises nothing."""
    code = ("import sys, torch\n"
            "from repro_torch.kernels import _build, flash_attention as f\n"
            "assert f.route(torch.bfloat16, 128) == 'tensor_core'\n"
            "assert f.KERNEL.launches == 0 and not f.KERNEL.route_launches\n"
            "assert not _build._LIBS and not torch.cuda.is_initialized()\n"
            "assert 'triton' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
