"""Sliding-window serving on the port against the reference: REDUCED
starcoder2-7b (dense, window 16, layer norm, attention bias) and
mixtral-8x7b (MoE, window 16) at f32, served past the ring wrap and
prefilled past the window, and tests/test_swa.py's window-mask battery on
the port's plain paths (flash's window mask, decode against the ring
cache, `slot_positions`, the `write_prefill` ring round trip), each held
to the reference's dense oracle `repro.kernels.ref.flash_attention`.

Tolerances: serving parity is token identity; logits within 1e-4 of their
scale (tests/test_torch_serve.py's f32 LOGIT_TOL); attention outputs
within 1e-5 (tests/test_swa.py's band); cache contents and positions
equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED
from repro.kernels import ref as JR
from repro.models import Shardings, forward, init_cache, init_params
from repro.serve import Request, ServeEngine
from repro_torch import bridge
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.kernels import ops as T_ops
from repro_torch.models import cache as TC
from repro_torch.models import forward as t_forward
from repro_torch.models import init_cache as t_init_cache
from repro_torch.models import layers as TL
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

SHD = Shardings(None)
WINDOWED = ["starcoder2-7b", "mixtral-8x7b"]
LOGIT_TOL = 1e-4
ATT_TOL = 1e-5
KEY = jax.random.PRNGKey(10)


@functools.cache
def _model(name):
    cfg = dataclasses.replace(REDUCED[name], dtype="float32")
    tcfg = dataclasses.replace(T_REDUCED[name], dtype="float32")
    params = init_params(jax.random.PRNGKey(0), cfg, SHD)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
    return cfg, tcfg, params, tparams


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ #
# serving past the ring wrap (gate 1) and prefill past the window (gate 2)
# ------------------------------------------------------------------ #

def _run_16_steps_wrapping(eng, prompts, make_request):
    """tests/test_serve.py's wrapping schedule: 16 continuous-batching
    steps, budgets of 8 tokens, so positions cross the ring width."""
    reqs = [make_request(i, p, 8) for i, p in enumerate(prompts)]
    pending = list(reqs)
    for _ in range(16):
        while pending and eng.admit(pending[0]):
            pending.pop(0)
        eng.step()
    return {r.rid: (list(r.out_tokens), r.done) for r in reqs}


@pytest.mark.parametrize("name", WINDOWED)
def test_serve_past_the_ring_wrap_token_identical(name):
    cfg, tcfg, params, tparams = _model(name)
    assert TC.cache_width(tcfg, 32) == cfg.sliding_window == 16
    key = jax.random.PRNGKey(17)
    prompts = [np.array(jax.random.randint(
        jax.random.fold_in(key, i), (12 + i % 3,), 0, cfg.vocab_size,
        dtype=jnp.int32)) for i in range(4)]
    ref = _run_16_steps_wrapping(
        ServeEngine(cfg, params, batch_slots=2, max_len=32, shd=SHD),
        [jnp.asarray(p) for p in prompts], Request)
    eng = TServeEngine(tcfg, tparams, batch_slots=2, max_len=32,
                       device="cpu")
    assert eng.cache["layers"][0]["k"].shape[2] == 16       # a ring
    got = _run_16_steps_wrapping(eng, [torch.from_numpy(p) for p in prompts],
                                 TRequest)
    assert any(len(p) + len(toks) > 16
               for p, (toks, _) in zip(prompts, got.values()))
    assert got == ref


@pytest.mark.parametrize("plen", [17, 22, 31])
@pytest.mark.parametrize("name", WINDOWED)
def test_prefill_longer_than_the_window(name, plen):
    """A prompt longer than the window: flash's window mask on the prompt,
    the ring keeps the last 16 positions, and 4 decode steps read it."""
    cfg, tcfg, params, tparams = _model(name)
    toks = np.random.default_rng(plen).integers(
        0, cfg.vocab_size, (1, plen)).astype(np.int32)
    jl, jc, ja = forward(params, cfg, SHD, tokens=jnp.asarray(toks),
                         cache=init_cache(cfg, 1, 40))
    tl, tc, ta = t_forward(tparams, tcfg, tokens=torch.from_numpy(toks),
                           cache=t_init_cache(tcfg, 1, 40, device="cpu"))
    assert tc["layers"][0]["k"].shape[2] == 16
    for step in range(5):
        want = np.asarray(jl, np.float32)[..., :cfg.vocab_size]
        np.testing.assert_allclose(
            tl.numpy()[..., :cfg.vocab_size], want, rtol=0,
            atol=LOGIT_TOL * float(np.abs(want).max()), err_msg=str(step))
        assert abs(float(ta) - float(ja)) <= 1e-6
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jl, jc, ja = forward(params, cfg, SHD, tokens=jnp.asarray(nxt),
                             cache=jc)
        tl, tc, ta = t_forward(tparams, tcfg, tokens=torch.from_numpy(nxt),
                               cache=tc)
    assert int(tc["index"]) == int(jc["index"]) == plen + 5


# ------------------------------------------------------------------ #
# the window-mask battery (gate 3), on the port's plain paths
# ------------------------------------------------------------------ #

def _qkv(seq, h=4, kvh=2, hd=16):
    """tests/test_swa.py's draw: (jax arrays, the same as tensors)."""
    def k(i):
        return jax.random.fold_in(KEY, i)
    q = jax.random.normal(k(0), (1, seq, h, hd), jnp.float32) / 4
    kk = jax.random.normal(k(1), (1, seq, kvh, hd), jnp.float32) / 4
    v = jax.random.normal(k(2), (1, seq, kvh, hd), jnp.float32) / 4
    return (q, kk, v), (_t(q), _t(kk), _t(v))


@pytest.mark.parametrize("window", [7, 8, 9, 16, 31, 32])
def test_prefill_flash_mask_matches_oracle(window):
    (q, k, v), (tq, tk, tv) = _qkv(32)
    want = np.asarray(JR.flash_attention(q, k, v, causal=True,
                                         window=window))
    got = T_ops.flash_attention(tq, tk, tv, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATT_TOL,
                               atol=ATT_TOL)


@pytest.mark.parametrize("window", [7, 8, 9, 16, 31, 32])
def test_decode_ring_validity_matches_oracle(window):
    """Token by token into the ring (`write_decode`), each step's
    `cached_attention` equals the oracle's row, past every wrap."""
    seq = 32
    (q, k, v), (tq, tk, tv) = _qkv(seq)
    tcfg = dataclasses.replace(T_REDUCED["granite-3-8b"], dtype="float32",
                               sliding_window=window)
    width = TC.cache_width(tcfg, seq)
    assert width == min(window, seq)
    kv = {"k": torch.zeros(1, width, 2, 16), "v": torch.zeros(1, width, 2, 16)}
    want = np.asarray(JR.flash_attention(q, k, v, causal=True,
                                         window=window))
    for t in range(seq):
        kv = TC.write_decode(kv, tk[:, t:t + 1], tv[:, t:t + 1], t, width)
        o = TL.cached_attention(tq[:, t:t + 1], kv["k"], kv["v"], t, tcfg)
        np.testing.assert_allclose(o[0, 0].numpy(), want[0, t],
                                   rtol=ATT_TOL, atol=ATT_TOL,
                                   err_msg=f"decode position {t}")


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("count", [0, 1, 3, 4, 5, 7, 8, 9, 16, 17])
def test_slot_positions_bijection(width, count):
    pos = TC.slot_positions(count, width).tolist()
    held = sorted(p for p in pos if p >= 0)
    assert held == list(range(max(0, count - width), count))
    for s, p in enumerate(pos):
        if p >= 0:
            assert p % width == s, f"slot {s} holds position {p}"
    assert sum(p < 0 for p in pos) == width - len(held)


def test_slot_positions_per_row_matches_scalar():
    counts = [0, 3, 8, 13]
    batched = TC.slot_positions(torch.tensor(counts, dtype=torch.int32), 8)
    for r, c in enumerate(counts):
        assert torch.equal(batched[r], TC.slot_positions(c, 8))


@pytest.mark.parametrize("s", [5, 8, 11, 16, 21])
def test_write_prefill_ring_roundtrip(s):
    """After `write_prefill` every occupied slot holds the row of its
    `slot_positions` position; the next decode step's read of the ring
    equals the oracle over the whole untruncated sequence."""
    width, kvh, hd = 8, 2, 16

    def k(i):
        return jax.random.fold_in(KEY, i)
    kf = _t(jax.random.normal(k(3), (1, s, kvh, hd), jnp.float32) / 4)
    vf = _t(jax.random.normal(k(4), (1, s, kvh, hd), jnp.float32) / 4)
    ring = {"k": torch.zeros(1, width, kvh, hd),
            "v": torch.zeros(1, width, kvh, hd)}
    ring = TC.write_prefill(ring, kf, vf)
    for slot, p in enumerate(TC.slot_positions(s, width).tolist()):
        if p >= 0:
            assert torch.equal(ring["k"][0, slot], kf[0, p]), (slot, p)
            assert torch.equal(ring["v"][0, slot], vf[0, p]), (slot, p)

    kn = jax.random.normal(k(5), (1, 1, kvh, hd), jnp.float32) / 4
    vn = jax.random.normal(k(6), (1, 1, kvh, hd), jnp.float32) / 4
    q = jax.random.normal(k(7), (1, 1, 4, hd), jnp.float32) / 4
    ring = TC.write_decode(ring, _t(kn), _t(vn), s, width)
    tcfg = dataclasses.replace(T_REDUCED["granite-3-8b"], dtype="float32",
                               sliding_window=width)
    o_ring = TL.cached_attention(_t(q), ring["k"], ring["v"], s, tcfg)
    # the oracle: query at position s over all s + 1 keys, window `width`
    kfull = jnp.concatenate([jnp.asarray(kf.numpy()), kn], axis=1)
    vfull = jnp.concatenate([jnp.asarray(vf.numpy()), vn], axis=1)
    qfull = jnp.concatenate([jnp.zeros((1, s, 4, hd)), q], axis=1)
    want = np.asarray(JR.flash_attention(qfull, kfull, vfull, causal=True,
                                         window=width))[:, -1:]
    np.testing.assert_allclose(o_ring.numpy(), want, rtol=ATT_TOL,
                               atol=ATT_TOL)
