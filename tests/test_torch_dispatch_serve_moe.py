"""`ServeEngine(engine="dispatch")` of the port on REDUCED mixtral-8x7b
(routed MoE, 4 experts top-2, sliding window; f32, the reference's
weights bridged) against the reference's fused engine, over
tests/test_serve.py's 16-step continuous-batching schedule: planned
decode, every layer's attention, router and expert forced onto the PIM
face (the intra-PIM exchanges relayed by the executor, the expert FFN
sharded over the expert axis of 2 banks), the expert-parallel DAG with
`expert_shards=2` on two ranks, a single-chunk dispatch prefill (whose
expert capacity is the whole prompt's), and int8 experts. Each is token
for token the reference's fused engine; decode logits are bit for bit
the port's fused engine's."""

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
from test_torch_dispatch_serve import prompts, run_16_steps

SHD = Shardings(None)


@functools.cache
def model(quant=""):
    cfg = dataclasses.replace(REDUCED["mixtral-8x7b"], dtype="float32",
                              quant=quant)
    tcfg = dataclasses.replace(T_REDUCED["mixtral-8x7b"], dtype="float32",
                               quant=quant)
    params = init_params(jax.random.PRNGKey(0), cfg, SHD)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
    return cfg, tcfg, params, tparams


@functools.cache
def reference_tokens(seed, quant=""):
    cfg, _, params, _ = model(quant)
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=48, shd=SHD)
    return run_16_steps(eng, [jnp.asarray(p) for p in prompts(cfg, 8, seed)],
                        Request)


def port_run(seed, quant="", **engine_kwargs):
    cfg, tcfg, _, tparams = model(quant)
    eng = TServeEngine(tcfg, tparams, batch_slots=2, max_len=48,
                       device="cpu", **engine_kwargs)
    logits = []
    if eng._dispatch_decode is not None:
        real = eng._dispatch_decode.logits
        eng._dispatch_decode.logits = \
            lambda *a: logits.append(real(*a)) or logits[-1]
    else:
        real = t_engine.forward

        def recording(*a, **kw):
            out = real(*a, **kw)
            if kw["tokens"].shape[1] == 1:
                logits.append(out[0].clone())
            return out
        t_engine.forward = recording
    try:
        toks = run_16_steps(eng, [torch.from_numpy(p)
                                  for p in prompts(cfg, 8, seed)], TRequest)
    finally:
        if eng._dispatch_decode is None:
            t_engine.forward = real
    return toks, logits, eng


@functools.cache
def fused(seed, quant=""):
    toks, logits, _ = port_run(seed, quant)
    return toks, logits


def _check(seed, quant="", **dispatch_kwargs):
    toks, logits, eng = port_run(seed, quant, engine="dispatch",
                                 dispatch_kwargs=dispatch_kwargs)
    assert toks == reference_tokens(seed, quant)
    if dispatch_kwargs.get("prefill_engine") == "jit":
        want_toks, want_logits = fused(seed, quant)
        assert toks == want_toks and len(logits) == len(want_logits)
        assert all(torch.equal(a, b) for a, b in zip(logits, want_logits))
    return eng


def test_moe_decode_token_identical():
    eng = _check(11, prefill_engine="jit")
    dag = eng._dispatch_decode.dag
    assert eng.dispatch_plan.method == "dag-dp"
    assert ("router0", "expert0") in dag.exchange_edges
    assert ("expert0", "combine0") in dag.exchange_edges


def test_moe_forced_expert_pim_token_identical():
    cfg = model()[1]
    forced = {f"{k}{i}": "upmem_2556" for i in range(cfg.n_blocks)
              for k in ("attn", "router", "expert")}
    eng = _check(13, grid=BankGrid(2, "cpu"), force_assignment=forced,
                 prefill_engine="jit")
    ex = eng._dispatch_decode.executor
    assert sorted(ex._exchange_in) == \
        sorted(f"expert{i}" for i in range(cfg.n_blocks))
    st = eng._dispatch_decode.faces.stats
    assert st["by_kind"]["expert"]["calls"] > 0 and not st["fallbacks"]


def test_moe_expert_sharded_decode_token_identical():
    cfg = model()[1]
    forced = {}
    for i in range(cfg.n_blocks):
        forced[f"expert{i}@r0"] = "upmem_2556"
        forced[f"expert{i}@r1"] = "upmem_2556:1"
    eng = _check(17, expert_shards=2, force_assignment=forced,
                 devices=("xeon", "upmem_2556", "upmem_2556:1"),
                 prefill_engine="jit")
    dag = eng._dispatch_decode.dag
    assert "expert0@r1" in dag.nodes and "expert0" not in dag.nodes
    assert ("router0", "expert0@r1") in dag.exchange_edges
    assert eng._dispatch_decode.assignment["expert0@r1"] == "upmem_2556:1"


def test_moe_single_chunk_prefill_token_identical():
    eng = _check(11, prefill_chunk=48)
    pre = eng._dispatch_prefill.dag
    assert any(n.startswith("router") for n in pre.nodes)
    assert pre.exchange_edges


@pytest.mark.parametrize("mode", ["plan", "pim"])
def test_int8_experts_token_identical(mode):
    cfg = model("int8")[1]
    dk = {"prefill_engine": "jit"}
    if mode == "pim":
        dk["grid"] = BankGrid(2, "cpu")
        dk["force_assignment"] = {f"expert{i}": "upmem_2556"
                                  for i in range(cfg.n_blocks)}
    eng = _check(11, "int8", **dk)
    assert eng._dispatch_decode.dag.name.startswith("lm-moe-decode-dag-int8")
