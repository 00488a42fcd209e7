"""The port's kernel functions on the CPU (their plain PyTorch versions,
reached through `repro_torch.kernels.ops`) against the reference's Pallas
kernels in interpret mode and its `kernels/ref.py`, over the sweeps of
tests/test_kernels.py, plus the per-row-lengths decode form against the
reference model's `layers.cached_attention`. The CUDA kernels themselves
run only on the card (chip_smoke.py); here their wrappers are held to
their argument checks.

Tolerances are test_kernels.py's: 1e-4 at f32, 2e-2 (decode) and 3e-2
(flash) at bf16."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import Shardings
from repro.models import cache as JC
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops
from repro_torch.models import layers as TL

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


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


@pytest.mark.parametrize("b,h,kvh,hd,w,length", [
    (2, 8, 2, 64, 1000, 777),
    (1, 4, 4, 128, 512, 512),
    (2, 16, 2, 64, 2048, 1),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention(b, h, kvh, hd, w, length, dtype):
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        10, DTYPES[dtype], (b, h, hd), (b, w, kvh, hd), (b, w, kvh, hd))
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    got = ops.decode_attention(qt, kt, vt, length)
    assert got.dtype == qt.dtype and tuple(got.shape) == (b, h, hd)
    _close(got, jref.decode_attention(qj, kj, vj, length), tol)
    _close(got, jops.decode_attention(qj, kj, vj, jnp.int32(length),
                                      interpret=True), tol)
    # a scalar length is the broadcast case of per-row lengths
    rows = torch.full((b,), length, dtype=torch.int32)
    assert torch.equal(ops.decode_attention(qt, kt, vt, rows), got)


def test_decode_attention_per_row_lengths():
    b, h, kvh, hd, w = 3, 4, 2, 16, 40
    (_, _, _), (qt, kt, vt) = _inputs(11, jnp.float32, (b, h, hd),
                                      (b, w, kvh, hd), (b, w, kvh, hd))
    lengths = torch.tensor([1, 17, 40], dtype=torch.int32)
    got = ops.decode_attention(qt, kt, vt, lengths)
    for i, n in enumerate(lengths.tolist()):
        row = ops.decode_attention(qt[i:i + 1], kt[i:i + 1, :n],
                                   vt[i:i + 1, :n], n)
        torch.testing.assert_close(got[i:i + 1], row, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch,width,index", [
    ("granite-3-8b", 32, [0, 6, 31]),       # full cache (W == max_len)
    ("starcoder2-7b", 16, [3, 16, 41]),     # ring cache (W == window), past the wrap
])
def test_cached_attention_matches_reference(arch, width, index):
    cfg, tcfg = REDUCED[arch], T_REDUCED[arch]
    b = len(index)
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        12, jnp.float32, (b, 1, cfg.n_heads, cfg.hd),
        (b, width, cfg.n_kv_heads, cfg.hd), (b, width, cfg.n_kv_heads, cfg.hd))
    idx = np.array(index, np.int32)
    pos = JC.slot_positions(jnp.asarray(idx) + 1, width)
    want = JL.cached_attention(qj, kj, vj, pos, jnp.asarray(idx), cfg,
                               Shardings(None))
    got = TL.cached_attention(qt, kt, vt, torch.from_numpy(idx), tcfg)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("sq,skv,h,kvh,hd,causal,window", [
    (300, 300, 4, 2, 64, True, 0),      # GQA, causal, ragged seq
    (512, 512, 2, 2, 128, True, 64),    # sliding window
    (256, 700, 4, 1, 64, False, 0),     # cross-attention-like, ragged kv
    (128, 512, 2, 2, 64, True, 32),     # window smaller than a kv tile
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention(sq, skv, h, kvh, hd, causal, window, dtype):
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        20, DTYPES[dtype], (1, sq, h, hd), (1, skv, kvh, hd),
        (1, skv, kvh, hd))
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert got.dtype == qt.dtype and tuple(got.shape) == (1, sq, h, hd)
    _close(got, jref.flash_attention(qj, kj, vj, causal=causal,
                                     window=window), tol)
    _close(got, jops.flash_attention(qj, kj, vj, causal=causal,
                                     window=window, interpret=True), tol)


@pytest.mark.parametrize("sq,skv,causal,window", [
    (40, 16, True, 4),       # causal, rows 19..39 see no key
    (300, 100, False, 32),   # windowed cross-attention, rows 131..299
])
def test_flash_attention_rows_without_keys(sq, skv, causal, window):
    """Rows with no unmasked key (q_pos >= Skv + window - 1): every score
    is -1e30, the softmax is uniform, and the row is the mean of V over
    all Skv keys, as in the reference oracle. The CUDA kernel is held to
    this in chip_smoke.py phase 3."""
    (qj, kj, vj), (qt, kt, vt) = _inputs(
        22, jnp.float32, (2, sq, 4, 32), (2, skv, 2, 32), (2, skv, 2, 32))
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    _close(got, jref.flash_attention(qj, kj, vj, causal=causal,
                                     window=window), 1e-5)
    first = skv + window - 1
    mean = vt.mean(dim=1).repeat_interleave(2, dim=1)      # (B, H, hd)
    torch.testing.assert_close(
        got[:, first:], mean[:, None].expand(-1, sq - first, -1, -1),
        rtol=1e-5, atol=1e-6)
    assert not torch.allclose(got[:, first - 1], mean)


def test_flash_attention_matches_model_prefill():
    """The prefill branch's function: the reference model's
    `_plain_attention` (causal, window from the config)."""
    from repro.models.transformer import _plain_attention
    cfg = dataclasses.replace(REDUCED["starcoder2-7b"], sliding_window=5)
    (qj, kj, vj), (qt, kt, vt) = _inputs(21, jnp.float32, (2, 13, 4, 16),
                                         (2, 13, 2, 16), (2, 13, 2, 16))
    _close(ops.flash_attention(qt, kt, vt, True, 5),
           _plain_attention(qj, kj, vj, cfg, causal=True), 1e-5)


def test_wrappers_reject_bad_arguments():
    q, k = torch.zeros(2, 8, 16), torch.zeros(2, 10, 2, 16)
    with pytest.raises(ValueError):
        ops.decode_attention(q, k, torch.zeros(2, 10, 2, 8), 3)   # k != v
    with pytest.raises(ValueError):
        ops.decode_attention(q[..., :8], k, k, 3)                  # hd
    with pytest.raises(ValueError):
        ops.decode_attention(q.half(), k.half(), k.half(), 3)      # dtype
    with pytest.raises(ValueError):
        ops.decode_attention(q.int(), k.int(), k.int(), 3)
    with pytest.raises(ValueError):
        ops.decode_attention(torch.zeros(2, 7, 16), k, k, 3)       # H % KVH
    fq = torch.zeros(1, 5, 4, 16)
    fk = torch.zeros(1, 6, 2, 16)
    with pytest.raises(ValueError):
        ops.flash_attention(fq, fk[..., :8], fk[..., :8])
    with pytest.raises(ValueError):
        ops.flash_attention(fq, fk, fk.bfloat16())
    with pytest.raises(ValueError):
        ops.flash_attention(fq, fk, fk, window=-1)
    with pytest.raises(ValueError):
        ops.flash_attention(fq[0], fk, fk)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: handed CPU tensors they raise
    before building anything."""
    q, k = torch.zeros(2, 8, 16), torch.zeros(2, 10, 2, 16)
    with pytest.raises(ValueError, match="CUDA"):
        kda.decode_attention(q, k, k, torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        kfa.flash_attention(torch.zeros(1, 5, 4, 16),
                            torch.zeros(1, 6, 2, 16),
                            torch.zeros(1, 6, 2, 16))
    assert kda.KERNEL.launches == 0 and kfa.KERNEL.launches == 0
    assert set(ops.kernels()) == {"decode_attention", "flash_attention",
                                  "va", "reduction", "stream_ops", "gemv"}
