"""`ServeEngine(engine="dispatch")` of the port on REDUCED starcoder2-7b
(dense, window 16, attention bias; f32, the reference's weights
bridged): at max_len 32 the KV cache is a ring of width 16, so decode
slots wrap and a slot's index is not its position. Dispatch decode whose
positions cross the ring is token for token the reference's fused
engine (logits bit for bit the port's fused engine's); the banded
dispatch prefill (22-token prompts in 4-token chunks: the last chunk
drops chunk 0's dead keys, the kernel's q_offset counting from the first
live key) is token for token the reference's fused engine, as
tests/test_serve.py holds the reference's own."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import REDUCED
from repro.models import Shardings, init_params
from repro.serve import Request, ServeEngine
from repro_torch import bridge
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.dispatch import workloads
from repro_torch.models import cache as cache_lib
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import dispatch_engine
from repro_torch.serve import engine as t_engine

SHD = Shardings(None)


@functools.cache
def model():
    cfg = dataclasses.replace(REDUCED["starcoder2-7b"], dtype="float32")
    tcfg = dataclasses.replace(T_REDUCED["starcoder2-7b"], dtype="float32")
    params = init_params(jax.random.PRNGKey(0), cfg, SHD)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
    return cfg, tcfg, params, tparams


def _prompts(cfg, key, plens):
    return [np.array(jax.random.randint(
        jax.random.fold_in(jax.random.PRNGKey(key), i), (n,), 0,
        cfg.vocab_size, dtype=jnp.int32)) for i, n in enumerate(plens)]


def _run(eng, ps, budget, steps, make_request):
    reqs = [make_request(i, p, budget) for i, p in enumerate(ps)]
    pending = list(reqs)
    for _ in range(steps):
        while pending and eng.admit(pending[0]):
            pending.pop(0)
        eng.step()
    return {r.rid: (list(r.out_tokens), r.done) for r in reqs}


def _both(ps, budget, steps, **dispatch_kwargs):
    """The reference's fused run and the port's dispatch run of the same
    schedule: (reference tokens, port tokens, engine, the port's decode
    logits)."""
    cfg, tcfg, params, tparams = model()
    want = _run(ServeEngine(cfg, params, batch_slots=2, max_len=32,
                            shd=SHD), [jnp.asarray(p) for p in ps],
                budget, steps, Request)
    eng = TServeEngine(tcfg, tparams, batch_slots=2, max_len=32,
                       device="cpu", engine="dispatch",
                       dispatch_kwargs=dispatch_kwargs)
    logits, inner = [], eng._dispatch_decode.logits
    eng._dispatch_decode.logits = \
        lambda *a: logits.append(inner(*a)) or logits[-1]
    got = _run(eng, [torch.from_numpy(p) for p in ps], budget, steps,
               TRequest)
    return want, got, eng, logits


def test_windowed_dispatch_decode_wraps_the_ring():
    cfg, tcfg, _, tparams = model()
    assert cache_lib.cache_width(tcfg, 32) == 16          # a ring
    assert dispatch_engine.dims_for_config(tcfg, 2, 32).window == \
        cfg.sliding_window
    ps = _prompts(cfg, 17, [12 + i % 3 for i in range(4)])
    want, got, _, seen = _both(ps, 8, 16, prefill_engine="jit")
    assert any(len(p) + len(t) > 16 for p, (t, _) in zip(ps, want.values()))
    assert got == want
    # and bit for bit the port's fused decode
    logits, real = [], t_engine.forward

    def recording(*a, **kw):
        out = real(*a, **kw)
        if kw["tokens"].shape[1] == 1:
            logits.append(out[0].clone())
        return out
    t_engine.forward = recording
    try:
        fused = _run(TServeEngine(tcfg, tparams, batch_slots=2, max_len=32,
                                  device="cpu"),
                     [torch.from_numpy(p) for p in ps], 8, 16, TRequest)
    finally:
        t_engine.forward = real
    assert fused == want
    assert len(seen) == len(logits) > 8
    assert all(torch.equal(a, b) for a, b in zip(seen, logits))


def test_windowed_banded_prefill_token_identical():
    cfg = model()[0]
    ps = _prompts(cfg, 23, [22, 20, 9, 18])
    want, got, eng, _ = _both(ps, 3, 12, prefill_chunk=4)
    step = eng._dispatch_prefill
    lf = workloads.prefill_live_from(step.chunk_splits(22),
                                     cfg.sliding_window)
    assert lf[-1] == 1                      # banding actually engages
    assert step._skeleton(22).name == "lm-prefill-dag-swa16"
    assert got == want
