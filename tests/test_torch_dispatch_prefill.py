"""`ServeEngine(engine="dispatch")` of the port on REDUCED granite-3-8b
(f32, the reference's weights bridged): the chunked dispatch prefill
and the engine's edges.

The chunked dispatch prefill (4-token chunks, prompts of 1-3 chunks, on
1 bank under the plan and on 2 banks with the ladders forced onto the
PIM face, ragged tails falling back to the host face) serves
token-identical to the reference's fused engine over
tests/test_serve.py's 16-step schedule, its first-token logits within
1e-5 of their scale. Also: the chunk attention stage against the
reference's, the three-layer hybrid (off-graph reads pinned by `keep`),
budget-1, EOS at admit, the `prefill_splits` hook, `attach_tracer`
spans and the FaceCache's steady state, and the reference's messages
for configs the dispatch path refuses."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED
from repro.models import forward, init_cache
from repro.serve import dispatch_engine as j_dispatch
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.core.bank_parallel import BankGrid
from repro_torch.dispatch.trace import Trace
from repro_torch.models import forward as t_forward
from repro_torch.models import init_cache as t_init_cache
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from repro_torch.serve import dispatch_engine
from test_torch_dispatch_serve import (SHD, model, port_run, prompts,
                                       reference_tokens)

PREFILL_REL = 1e-5


def _first_token_logits(tcfg, tparams, cfg, params, prompt, step):
    jl, _, _ = forward(params, cfg, SHD, tokens=jnp.asarray(prompt)[None],
                       cache=init_cache(cfg, 1, 48))
    cache = t_init_cache(tcfg, 2, 48, device="cpu")
    got = step(tparams, cache, torch.from_numpy(prompt).long(), 1)
    return np.asarray(jl[0, -1]), got.numpy(), cache


@pytest.mark.parametrize("n_banks,mode", [(1, "plan"), (2, "pim")])
def test_dispatch_prefill_decode_token_identical(n_banks, mode):
    """Chunked prefill (4-token chunks: prompts of 1-3 chunks with ragged
    tails) and decode both planner-routed: tokens identical to the
    reference's fused engine; each prompt's first-token logits within
    1e-5 of their scale of the reference's fused prefill."""
    cfg, tcfg, params, tparams = model()
    pk = {"grid": BankGrid(n_banks, "cpu"), "prefill_chunk": 4}
    if mode == "pim":
        pk["prefill_force_assignment"] = {
            f"{k}{i}/c{c}": "upmem_2556" for c in range(4)
            for i in range(cfg.n_layers) for k in ("qkv", "attn", "o")}
    toks, _, eng = port_run(2, engine="dispatch", dispatch_kwargs=pk)
    assert toks == reference_tokens(2)
    step = eng._dispatch_prefill
    assert step.n_chunks_planned == 4 and step.plan.objective == "overlapped"
    assert eng.prefill_plan is step.plan
    by_chunks = {-(-len(p) // 4): p for p in prompts(cfg, 8, 11)}
    assert sorted(by_chunks) == [1, 2, 3]
    for p in by_chunks.values():
        want, got, cache = _first_token_logits(tcfg, tparams, cfg, params,
                                               p, step)
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got[:cfg.vocab_size],
                                   want[:cfg.vocab_size], rtol=0,
                                   atol=PREFILL_REL * scale)
        assert int(cache["index"]) == len(p)
        assert not cache["layers"][0]["k"][:, 0].any()   # other slot
    if mode == "pim":
        st = step.faces.stats
        assert st["pim"]["calls"] > 0
        assert st["fallbacks"]                 # ragged 3-token tails


def test_prefill_is_pipelined_across_chunks():
    """A two-chunk prompt's executed order interleaves chunks: chunk 1's
    qkv is issued before chunk 0's mlp, as the reference's is."""
    _, tcfg, _, _ = model()
    step = dispatch_engine.DispatchPrefillStep(tcfg, max_len=48, chunk=4,
                                               device="cpu")
    flat = [n for _, nodes in step._executor_for([4, 4]).executed_order()
            for n in nodes]
    assert flat.index("qkv0/c1") < flat.index("mlp0/c0")
    assert step.chunk_splits(11) == [4, 4, 3]
    devs = step.devices_for(4 * step.n_chunks_planned + 6)
    last = step.n_chunks_planned - 1
    assert devs[f"qkv0/c{last + 2}"] == step.assignment[f"qkv0/c{last}"]


def test_prefill_past_the_planned_horizon():
    """A 22-token prompt in 4-token chunks is 6 chunks, past the 4 the
    step plans by default: chunks 4 and 5 route as chunk 3 (the
    `min(c, planned-1)` clamp). With chunk 3's ladders forced onto the
    PIM face at 2 banks, chunks 3-5 run there. First-token logits within
    1e-5 of scale of the reference's fused prefill; the slot's K/V rows,
    written by the qkv stages through views of the cache, within the
    same band of the port's fused prefill's, and zero past the prompt."""
    cfg, tcfg, params, tparams = model()
    n = cfg.n_layers
    force = {f"{k}{i}/c3": "upmem_2556" for i in range(n)
             for k in ("qkv", "attn", "o", "mlp")}
    step = dispatch_engine.DispatchPrefillStep(
        tcfg, max_len=48, chunk=4, grid=BankGrid(2, "cpu"),
        force_assignment=force, device="cpu")
    assert step.n_chunks_planned == 4 and step.chunk_splits(22) == \
        [4, 4, 4, 4, 4, 2]
    p = np.random.default_rng(5).integers(0, cfg.vocab_size, 22)
    want, got, cache = _first_token_logits(tcfg, tparams, cfg, params, p,
                                           step)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got[:cfg.vocab_size], want[:cfg.vocab_size],
                               rtol=0, atol=PREFILL_REL * scale)
    st = step.faces.stats
    assert st["pim"]["calls"] == 3 * 4 * n and not st["fallbacks"]
    one = t_init_cache(tcfg, 1, 48, device="cpu")
    t_forward(tparams, tcfg, tokens=torch.from_numpy(p).long()[None],
              cache=one)
    for name in ("k", "v"):
        rows, fused = (cache["layers"][0][name][:, 1],
                       one["layers"][0][name][:, 0])
        assert not rows[:, 22:].any()
        kscale = float(fused.abs().max())
        np.testing.assert_allclose(rows.numpy(), fused.numpy(), rtol=0,
                                   atol=PREFILL_REL * kscale)


def test_dropped_dispatch_engine_frees_without_the_cycle_collector():
    """The dispatch steps' FaceCaches bind the stage bodies to the config,
    not to the step: with the cycle collector off, dropping the engine
    frees the steps (and with them the weights' views and the cache)."""
    import gc
    import weakref
    _, tcfg, _, tparams = model()
    gc.collect()
    gc.disable()
    try:
        eng = TServeEngine(tcfg, tparams, batch_slots=2, max_len=48,
                           device="cpu", engine="dispatch",
                           dispatch_kwargs={"prefill_chunk": 4})
        eng.admit(TRequest(0, torch.arange(9) + 2, 3))
        eng.step()
        refs = [weakref.ref(x) for x in (
            eng, eng._dispatch_decode, eng._dispatch_prefill,
            eng.cache["layers"][0]["k"])]
        del eng
        assert [r() is None for r in refs] == [True] * 4
    finally:
        gc.enable()


@pytest.mark.parametrize("q0,k0,t,window", [
    (0, 0, 4, 0), (8, 0, 4, 0), (12, 4, 4, 8), (9, 3, 3, 5), (20, 12, 4, 6)])
def test_chunk_attention_against_the_reference_stage(q0, k0, t, window):
    """The prefill attn stage (explicit absolute positions; on the CPU its
    plain version, on the card the flash kernel with q_offset = q0 - k0)
    against the reference's `DispatchPrefillStep._attn_fn` and the flash
    wrapper's plain version."""
    rng = np.random.default_rng(q0 + 7 * k0)
    skv = q0 + t - k0
    q = rng.normal(size=(1, t, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, skv, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, skv, 2, 16)).astype(np.float32)
    jstage = type("S", (), {"cfg": type("C", (), {
        "sliding_window": window})()})()
    want = np.asarray(j_dispatch.DispatchPrefillStep._attn_fn(
        jstage, *map(jnp.asarray, (q, k, v)),
        jnp.arange(q0, q0 + t), jnp.arange(k0, q0 + t)))
    tcfg = dataclasses.replace(model()[1], sliding_window=window)
    got = dispatch_engine.DispatchPrefillStep._attn_fn(
        tcfg, *map(torch.from_numpy, (q, k, v)), range(q0, q0 + t),
        range(k0, q0 + t))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    from repro_torch.kernels import ops
    flash = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=True, window=window,
                                q_offset=q0 - k0)
    np.testing.assert_allclose(flash.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="refusing to mis-mask"):
        dispatch_engine.DispatchPrefillStep._attn_fn(
            tcfg, *map(torch.from_numpy, (q, k, v)), range(q0, q0 + t),
            range(0, q0 + t + 1))


def test_three_layer_hybrid_token_identical():
    """Three layers under a hybrid whose host and PIM groups alternate:
    every layer's qkv reads embed's rope tables off the graph, which
    `keep` pins (tests/test_serve.py's three-layer case)."""
    cfg, tcfg, _, _ = model(3)
    f = {"embed": "xeon", "qkv1": "upmem_2556", "attn1": "upmem_2556",
         "o2": "upmem_2556", "mlp0": "upmem_2556"}
    toks, _, _ = port_run(2, n_layers=3, engine="dispatch",
                          dispatch_kwargs={"force_assignment": f,
                                           "prefill_engine": "jit"})
    assert toks == reference_tokens(2, n_layers=3)


def test_budget_one_eos_at_admit_and_splits_hook():
    _, tcfg, _, tparams = model()
    dk = {"prefill_chunk": 4}
    eng = TServeEngine(tcfg, tparams, batch_slots=2, max_len=48,
                       device="cpu", engine="dispatch", dispatch_kwargs=dk)
    req = TRequest(0, torch.tensor([3, 1, 4, 1, 5]), max_new_tokens=1)
    assert eng.admit(req) and req.done and len(req.out_tokens) == 1
    assert eng.n_free == 2 and eng.step() == 0
    eng.eos_id = req.out_tokens[0]       # the same prompt again: EOS
    again = TRequest(1, torch.tensor([3, 1, 4, 1, 5]), max_new_tokens=8)
    assert eng.admit(again) and again.done
    assert again.out_tokens == req.out_tokens and eng.n_free == 2
    assert eng.prefill_splits(11) == [4, 4, 3]
    assert eng.prefill_splits(4) == [4]
    fused = TServeEngine(tcfg, tparams, batch_slots=1, max_len=48,
                         device="cpu")
    assert fused.prefill_splits(11) == [11]
    assert fused.dispatch_plan is None and fused.prefill_plan is None


def test_tracer_spans_and_facecache_steady_state():
    """A traced dispatch run records prefill_step and decode_step spans,
    a compute span per node and step, and cache hits; after warm-up the
    FaceCache builds nothing more."""
    _, tcfg, _, tparams = model()
    eng = TServeEngine(tcfg, tparams, batch_slots=2, max_len=48,
                       device="cpu", engine="dispatch",
                       dispatch_kwargs={"prefill_chunk": 4})
    tracer = Trace("serve:test")
    eng.attach_tracer(tracer)
    for i in range(2):
        eng.admit(TRequest(i, torch.arange(5) + 2, 1000))
    eng.step()
    st0 = eng._dispatch_decode.faces.stats
    for _ in range(3):
        eng.step()
    eng.attach_tracer(None)
    st1 = eng._dispatch_decode.faces.stats
    assert st1["compiles"] == st0["compiles"] > 0
    assert st1["hits"] - st0["hits"] == st1["calls"] - st0["calls"] > 0
    assert len(tracer.by_kind("prefill_step")) == 2
    steps = tracer.by_kind("decode_step")
    assert len(steps) == 4
    assert [e.attrs["step"] for e in steps] == [1, 2, 3, 4]
    assert all(e.attrs["n_live"] == 2
               and e.attrs["launch_s"] + e.attrs["sync_s"] <= e.dur_s
               for e in steps)
    n_nodes = len(eng._dispatch_decode.dag.nodes)
    prefill_nodes = len(eng._dispatch_prefill._skeleton(5).nodes)
    assert len(tracer.by_kind("compute")) == 4 * n_nodes \
        + 2 * prefill_nodes
    assert tracer.by_kind("cache_hit")
    eng.step()                                   # detached: no new events
    assert len(tracer.by_kind("decode_step")) == 4


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b",
                                  "whisper-tiny", "rwkv6-3b"])
def test_dispatch_refuses_what_the_reference_refuses(arch):
    with pytest.raises(ValueError) as want:
        j_dispatch._check_dispatchable(REDUCED[arch], SHD)
    with pytest.raises(ValueError) as got:
        TServeEngine(T_REDUCED[arch], {"embed": torch.zeros(1)},
                     batch_slots=1, max_len=16, device="cpu",
                     engine="dispatch")
    assert str(got.value) == str(want.value)
    _, tcfg, _, tparams = model()
    with pytest.raises(ValueError, match="engine must be"):
        TServeEngine(tcfg, tparams, batch_slots=1, max_len=16,
                     device="cpu", engine="nope")
