"""The whisper encoder-decoder in the port against `repro`, on REDUCED
whisper-tiny (2 encoder + 2 decoder layers, encoder_seq 24) with the
reference's weights, frame embeddings and tokens drawn with numpy from a
seed.

Tolerances as in tests/test_torch_zoo_rwkv.py: f32 within 1e-4 of the
scale, tests/test_models.py's twin at its 2e-2, serving token identity
at f32 (token prompts only, as the reference's engine admits: the
cross-attention then reads the zero cross cache)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED
from repro.models import transformer as JT
from repro_torch.models import transformer as TT
from test_torch_zoo_rwkv import (SHD, check_dispatch_raises,
                                 check_forward_prefill_decode,
                                 check_init_cache, check_launch_serve, close,
                                 decode_matches_full, flat, serve_both,
                                 zoo_model)

NAME = "whisper-tiny"


def _inputs(seed, b=2, s=10):
    cfg = REDUCED[NAME]
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "encoder_embeds": rng.normal(
                size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}


@pytest.mark.parametrize("s,d", [(24, 64), (1500, 384)])
def test_sinusoid_matches_reference(s, d):
    """f32 sin/cos of angles up to 1500 rad: the two libraries' argument
    reductions differ by a few ulp of the angle (measured 3.8e-6)."""
    close(TT._sinusoid(s, d), JT._sinusoid(s, d), 1e-5)


def test_encoder_forward_matches_reference():
    cfg, tcfg, params, tparams = zoo_model(NAME)
    enc = _inputs(1)["encoder_embeds"]
    want = jax.jit(lambda p, e: JT.encoder_forward(e, p, cfg, SHD))(
        params["encoder"], jnp.asarray(enc))
    close(TT.encoder_forward(torch.from_numpy(enc), tparams["encoder"], tcfg),
          want)


@pytest.mark.parametrize("s_pre", [1, 6])
def test_forward_prefill_decode_match_reference(s_pre):
    """The prefill fills the cross cache from the encoder output (equal to
    the reference's); the decode steps read it."""
    jc, tc = check_forward_prefill_decode(NAME, _inputs(s_pre), s_pre)
    want = flat(jc["layers"])
    got = flat(tc["layers"])
    assert "0.cross.k" in got and got["0.cross.k"].abs().max() > 0
    for path, t in got.items():
        close(t, want[path])


def test_whisper_cross_attention_cache():
    """tests/test_models.py::test_whisper_cross_attention_cache: decode
    steps without encoder input, on the cached cross K/V, reproduce the
    full forward."""
    cfg = REDUCED[NAME]
    key = jax.random.PRNGKey(14)
    enc = jax.random.normal(key, (2, cfg.encoder_seq, cfg.d_model),
                            jnp.float32)
    decode_matches_full(NAME, 2, 6, 10, 14,
                        inputs={"encoder_embeds": np.asarray(enc)})


def test_cross_attention_routes():
    """A decode step's cross-attention (one query) goes to the decode
    kernel's wrapper over all encoder_seq rows, a prefill's to the flash
    wrapper without the causal mask; the encoder's layers to flash."""
    from repro_torch.kernels import ops
    _, tcfg, _, tparams = zoo_model(NAME)
    calls = []
    saved = ops.decode_attention, ops.flash_attention

    def dec(q, k, v, lengths):
        calls.append(("decode", k.shape[1], int(lengths)))
        return saved[0](q, k, v, lengths)

    def fl(q, k, v, causal=True, window=0, q_offset=0):
        calls.append(("flash", k.shape[1], causal))
        return saved[1](q, k, v, causal, window, q_offset)

    inp = _inputs(2, b=1, s=5)
    cache = TT.cache_lib.init_cache(tcfg, 1, 16, "cpu")
    ops.decode_attention, ops.flash_attention = dec, fl
    try:
        _, cache, _ = TT.forward(
            tparams, tcfg, tokens=torch.from_numpy(inp["tokens"]).long(),
            encoder_embeds=torch.from_numpy(inp["encoder_embeds"]),
            cache=cache)
        n_pre = len(calls)
        TT.forward(tparams, tcfg, tokens=torch.zeros(1, 1, dtype=torch.long),
                   cache=cache)
    finally:
        ops.decode_attention, ops.flash_attention = saved
    es, n = tcfg.encoder_seq, tcfg.n_layers
    assert calls[:n_pre] == [("flash", es, False)] * tcfg.encoder_layers + [
        ("flash", 5, True), ("flash", es, False)] * n
    assert calls[n_pre:] == [("decode", 16, 6), ("decode", es, es)] * n


def test_serve_token_identical_to_reference():
    ref, got = serve_both(NAME)
    assert got == ref
    assert all(len(toks) == 3 + rid % 4 for rid, (toks, _) in got.items())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_cache_matches_reference(dtype):
    got = check_init_cache(NAME, dtype)
    cfg = REDUCED[NAME]
    assert tuple(got["layers.0.cross.k"].shape) == (
        cfg.n_blocks, 3, cfg.encoder_seq, cfg.n_kv_heads, cfg.hd)


def test_dispatch_engine_raises():
    check_dispatch_raises(NAME)


def test_launch_serve_runs_on_cpu(capsys):
    check_launch_serve(NAME, capsys)
