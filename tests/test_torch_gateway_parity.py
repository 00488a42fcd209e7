"""The port's gateway against the reference gateway, decision for decision.

Each case serves one seeded workload of tests/test_gateway.py through the
reference's `Gateway` over its fused engine and through the port's over
the port's engine, on REDUCED granite-3-8b (the reference's weights from
PRNGKey(0), bridged), each under its own `ManualClock`. The two runs must
give the same outcome of every request (state, reject reason, `admit_s`,
every token time), equal `GatewayStats` and plan-cache stats, and the
same plan-cache keys in the same LRU order: the clock is read at the same
points, and every admission the stall budget allows or refuses falls the
same way on the port's prices. At f32 the tokens are the reference's
too; at the reference's bf16 default only the decisions are compared (P1:
bf16 logits of the two frameworks round apart).

The cases are split over this file and
tests/test_torch_gateway_parity_{budget,churn}.py, so that each file
compiles the reference's engines of its own cases in well under a minute.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as j_serve
from repro.configs import REDUCED
from repro.models import Shardings, init_params
from repro_torch import bridge
from repro_torch import serve as t_serve
from repro_torch.configs import REDUCED as T_REDUCED

SHD = Shardings(None)


@functools.cache
def model(dtype):
    cfg = dataclasses.replace(REDUCED["granite-3-8b"], dtype=dtype)
    tcfg = dataclasses.replace(T_REDUCED["granite-3-8b"], dtype=dtype)
    params = init_params(jax.random.PRNGKey(0), cfg, SHD)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
    return cfg, tcfg, params, tparams


def _burst(pkg, specs, vocab):
    """tests/test_gateway.py's `_greq` requests: (rid, priority) pairs,
    all arriving at once."""
    out = []
    for rid, prio in specs:
        toks = [(rid * 7 + i) % vocab for i in range(4)]
        prompt = (jnp.asarray(toks, jnp.int32) if pkg is j_serve
                  else torch.tensor(toks, dtype=torch.int32))
        out.append(pkg.GatewayRequest(rid=rid, prompt=prompt,
                                      max_new_tokens=4, priority=prio))
    return out


def _poisson(*a, **kw):
    return lambda pkg, vocab: pkg.poisson_requests(*a, vocab=vocab, **kw)


#: name -> (engine kwargs, gateway kwargs, workload(pkg, vocab)): the
#: workloads of tests/test_gateway.py's integration cases, and the stall
#: budget's two extremes over a dense arrival stream
CASES = {
    "capacity": ({}, dict(queue_capacity=16),
                 _poisson(8, 100.0, seed=3, prompt_lens=(3, 8),
                          max_new=(2, 6))),
    "overload": (dict(batch_slots=1), dict(queue_capacity=2),
                 lambda pkg, v: _burst(pkg, [(i, 1) for i in range(8)], v)),
    "shed": (dict(batch_slots=1), dict(queue_capacity=2,
                                       shed_policy="shed"),
             lambda pkg, v: _burst(pkg, [(i, 2) for i in range(4)]
                                   + [(10 + i, 0) for i in range(2)], v)),
    "priority": (dict(batch_slots=1), dict(queue_capacity=16),
                 lambda pkg, v: _burst(pkg, [(0, 2), (1, 0), (2, 1),
                                             (3, 0)], v)),
    "poisson": ({}, dict(queue_capacity=16),
                _poisson(6, 80.0, seed=21, prompt_lens=(3, 8),
                         max_new=(2, 5))),
    "stall-0": ({}, dict(queue_capacity=16, max_stall_s=0.0),
                _poisson(6, 400.0, seed=3, prompt_lens=(3, 5),
                         max_new=(2, 6))),
    "stall-1e9": ({}, dict(queue_capacity=16, max_stall_s=1e9),
                  _poisson(6, 400.0, seed=3, prompt_lens=(3, 5),
                           max_new=(2, 6))),
    "churn": ({}, dict(queue_capacity=32, pos_bucket=8, tick=1e-4),
              _poisson(20, 150.0, seed=5, prompt_lens=(3, 10),
                       max_new=(2, 8))),
    "prewarm": (dict(batch_slots=2, max_len=32), dict(prewarm=(4, 5, 6)),
                _poisson(4, 100.0, seed=9, prompt_lens=(4, 6),
                         max_new=(2, 4))),
    "dispatch": (dict(batch_slots=2, engine="dispatch",
                      dispatch_kwargs={"prefill_chunk": 4}),
                 dict(queue_capacity=8),
                 _poisson(4, 100.0, seed=5, prompt_lens=(4, 5),
                          max_new=(3, 5))),
}


def run_case(pkg, name, dtype):
    """Serve case `name` through `pkg`'s gateway. Returns (outcome of each
    request by rid, stats as a tuple, prewarm's cache stats or None,
    plan-cache keys, tokens by rid)."""
    cfg, tcfg, params, tparams = model(dtype)
    ekw, gkw, workload = CASES[name]
    ekw, gkw = dict(ekw), dict(gkw)
    ekw.setdefault("batch_slots", 3)
    ekw.setdefault("max_len", 48)
    tick = gkw.pop("tick", 1e-3)
    prewarm = gkw.pop("prewarm", None)
    gkw.setdefault("pos_bucket", 16)
    if pkg is j_serve:
        eng = j_serve.ServeEngine(cfg, params, shd=SHD, **ekw)
    else:
        eng = t_serve.ServeEngine(tcfg, tparams, device="cpu", **ekw)
    gw = pkg.Gateway(eng, clock=pkg.ManualClock(tick=tick), **gkw)
    warm = gw.prewarm(prompt_lens=prewarm) if prewarm else None
    stats = gw.run(workload(pkg, cfg.vocab_size))
    everyone = gw.finished + gw.rejected
    outcome = {g.rid: (g.state, g.reject_reason, g.arrival_s, g.admit_s,
                       g.finish_s, tuple(g.token_times), g.priority)
               for g in everyone}
    tokens = {g.rid: g.out_tokens for g in everyone}
    return (outcome, dataclasses.astuple(stats), warm,
            list(gw.plans._entries), tokens)


@functools.cache
def reference(name, dtype):
    return run_case(j_serve, name, dtype)


def check_f32(name):
    """Case `name` at f32: decisions, stats, keys and tokens equal."""
    want = reference(name, "float32")
    got = run_case(t_serve, name, "float32")
    assert got[0] == want[0]                 # every request's outcome
    assert got[1] == want[1]                 # GatewayStats, plan cache
    assert got[2] == want[2]                 # prewarm's cache stats
    assert got[3] == want[3]                 # plan-cache keys, LRU order
    assert got[4] == want[4]                 # tokens
    assert sum(map(len, got[4].values())) > 0


def check_bf16(name):
    """Case `name` at bf16: decisions, stats and keys equal."""
    want = reference(name, "bfloat16")
    got = run_case(t_serve, name, "bfloat16")
    assert got[:4] == want[:4]
    assert {r: len(t) for r, t in got[4].items()} == \
        {r: len(t) for r, t in want[4].items()}


@pytest.mark.parametrize("name", ["capacity", "overload", "shed",
                                  "priority", "poisson"])
def test_f32_decisions_and_tokens_equal_the_reference(name):
    check_f32(name)


@pytest.mark.parametrize("name", ["shed"])
def test_bf16_decisions_equal_the_reference(name):
    check_bf16(name)
