"""`ServeEngine(engine="dispatch")` of the port on REDUCED granite-3-8b
(f32, the reference's weights bridged) against the reference's fused
engine and the port's own: decode.

Decode (prefill kept fused, `prefill_engine="jit"`, so both caches hold
the same bits) runs tests/test_serve.py's 16-step continuous-batching
schedule under the planner's plan, the reference's forced hybrid
(embed and attention on the PIM face) and all-PIM, at 1, 2 and 4
banks: tokens identical to the reference's fused engine, every decode
step's logits bit for bit the port's fused step's. The dispatch prefill
and the engine's edges are tests/test_torch_dispatch_prefill.py's."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED
from repro.models import Shardings, init_params
from repro.serve import Request, ServeEngine
from repro_torch import bridge
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.core.bank_parallel import BankGrid
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import engine as t_engine

SHD = Shardings(None)


@functools.cache
def model(n_layers=None):
    cfg = dataclasses.replace(REDUCED["granite-3-8b"], dtype="float32")
    tcfg = dataclasses.replace(T_REDUCED["granite-3-8b"], dtype="float32")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    params = init_params(jax.random.PRNGKey(0), cfg, SHD)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
    return cfg, tcfg, params, tparams


def prompts(cfg, n, seed):
    """tests/test_serve.py's prompt draw, as numpy."""
    out, key = [], jax.random.PRNGKey(seed)
    for _ in range(n):
        key, k = jax.random.split(key)
        plen = 3 + int(jax.random.randint(k, (), 0, 8))
        out.append(np.array(jax.random.randint(
            k, (plen,), 0, cfg.vocab_size, dtype=jnp.int32)))
    return out


def run_16_steps(eng, ps, make_request):
    """tests/test_serve.py's 16-step schedule: {rid: (tokens, done)}."""
    reqs = [make_request(i, p, 3 + i % 4) for i, p in enumerate(ps)]
    pending = list(reqs)
    for _ in range(16):
        while pending and eng.admit(pending[0]):
            pending.pop(0)
        eng.step()
    return {r.rid: (list(r.out_tokens), r.done) for r in reqs}


@functools.cache
def reference_tokens(slots, seed=11, n_layers=None):
    cfg, _, params, _ = model(n_layers)
    eng = ServeEngine(cfg, params, batch_slots=slots, max_len=48, shd=SHD)
    return run_16_steps(eng, [jnp.asarray(p) for p in prompts(cfg, 8, seed)],
                        Request)


def port_run(slots, seed=11, n_layers=None, **engine_kwargs):
    """The port's 16-step run: (tokens, every decode step's logits)."""
    cfg, tcfg, _, tparams = model(n_layers)
    logits = []
    eng = TServeEngine(tcfg, tparams, batch_slots=slots, max_len=48,
                       device="cpu", **engine_kwargs)
    step = eng._dispatch_decode
    if step is not None:
        real = step.logits
        step.logits = lambda *a: logits.append(real(*a)) or logits[-1]
    toks = run_16_steps(eng, [torch.from_numpy(p)
                              for p in prompts(cfg, 8, seed)], TRequest)
    return toks, logits, eng


@functools.cache
def fused_run(slots):
    """The port's fused 16-step run, each decode step's logits kept."""
    logits = []
    real = t_engine.forward

    def recording(*a, **kw):
        out = real(*a, **kw)
        if kw["tokens"].shape[1] == 1:
            logits.append(out[0].clone())
        return out
    t_engine.forward = recording
    try:
        toks, _, _ = port_run(slots)
    finally:
        t_engine.forward = real
    return toks, logits


def forced(cfg, mode):
    if mode == "plan":
        return None
    if mode == "hybrid":       # tests/test_serve.py's forced hybrid
        out = {f"attn{i}": "upmem_2556" for i in range(cfg.n_blocks)}
        out["embed"] = "upmem_2556"
        return out
    names = ["embed", "head"] + [f"{k}{i}" for i in range(cfg.n_blocks)
                                 for k in ("qkv", "attn", "o", "mlp")]
    return {n: "upmem_2556" for n in names}


@pytest.mark.parametrize("mode", ["plan", "hybrid", "pim"])
@pytest.mark.parametrize("n_banks", [1, 2, 4])
def test_dispatch_decode_token_identical_and_bitwise(mode, n_banks):
    cfg, tcfg, _, _ = model()
    slots = 4 if n_banks == 4 else 2
    toks, logits, eng = port_run(
        slots, engine="dispatch", dispatch_kwargs={
            "grid": BankGrid(n_banks, "cpu"), "prefill_engine": "jit",
            "force_assignment": forced(tcfg, mode)})
    want_toks, want_logits = fused_run(slots)
    assert toks == reference_tokens(slots) == want_toks
    assert len(logits) == len(want_logits) > 5
    assert all(torch.equal(a, b) for a, b in zip(logits, want_logits))
    faces = eng._dispatch_decode.faces.stats
    if mode == "plan":
        assert faces["pim"]["calls"] == 0       # all-host at this size
    else:
        assert faces["pim"]["calls"] > 0 and not faces["fallbacks"]
