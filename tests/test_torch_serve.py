"""The port's model forward and serving engine against the reference's,
on REDUCED granite-3-8b with the reference's weights (bridged).

Tolerances: f32 logits agree to 1e-4 of their scale (order of sums);
bf16 to 6e-2 of their scale (bf16 rounds at other places in the two
frameworks, and the drift compounds over 2 layers and 17 steps). Serving
parity is token identity at f32. Temperature sampling draws from a torch
generator, not jax.random, so it is outside parity scope."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED
from repro.models import Shardings, forward, init_cache, init_params
from repro.serve import Request, ServeEngine
from repro_torch import bridge
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.launch import serve as t_launch
from repro_torch.models import forward as t_forward
from repro_torch.models import init_cache as t_init_cache
from repro_torch.models import tree_map as t_tree_map
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

SHD = Shardings(None)
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 6e-2}


@functools.cache
def _model(dtype, name="granite-3-8b"):
    cfg = dataclasses.replace(REDUCED[name], dtype=dtype)
    tcfg = dataclasses.replace(T_REDUCED[name], dtype=dtype)
    params = init_params(jax.random.PRNGKey(0), cfg, SHD)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
    return dtype, cfg, tcfg, params, tparams


@pytest.fixture(params=["float32", "bfloat16"])
def model(request):
    return _model(request.param)


def _prompts(cfg, n, key):
    """tests/test_serve.py's prompt draw, as numpy."""
    out = []
    for _ in range(n):
        key, k = jax.random.split(key)
        plen = 3 + int(jax.random.randint(k, (), 0, 8))
        out.append(np.array(jax.random.randint(
            k, (plen,), 0, cfg.vocab_size, dtype=jnp.int32)))
    return out


def test_forward_prefill_and_16_decode_steps(model):
    dtype, cfg, tcfg, params, tparams = model
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    jc = init_cache(cfg, 2, 32)
    tc = t_init_cache(tcfg, 2, 32, device="cpu")
    jl, jc, _ = forward(params, cfg, SHD, tokens=jnp.asarray(toks), cache=jc)
    tl, tc, _ = t_forward(tparams, tcfg, tokens=torch.from_numpy(toks),
                          cache=tc)
    for step in range(17):
        want = np.asarray(jl, np.float32)[..., :cfg.vocab_size]
        got = tl.float().numpy()[..., :cfg.vocab_size]
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=LOGIT_TOL[dtype] * scale)
        assert bool((tl[..., cfg.vocab_size:] == -1e30).all())
        if step == 16:
            break
        # both sides decode the reference's greedy token (teacher forcing)
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jl, jc, _ = forward(params, cfg, SHD, tokens=jnp.asarray(nxt),
                            cache=jc)
        tl, tc, _ = t_forward(tparams, tcfg, tokens=torch.from_numpy(nxt),
                              cache=tc)
    assert int(tc["index"]) == int(jc["index"]) == 9 + 16


def _run_16_steps(eng, prompts, make_request):
    """tests/test_serve.py's fixed 16-step continuous-batching schedule
    with arrivals and evictions; {rid: (tokens, done)}."""
    reqs = [make_request(i, p, 3 + i % 4) for i, p in enumerate(prompts)]
    pending = list(reqs)
    for _ in range(16):
        while pending and eng.admit(pending[0]):
            pending.pop(0)
        eng.step()
    return {r.rid: (list(r.out_tokens), r.done) for r in reqs}


def test_serve_token_identical_to_reference():
    """The f32 gate (bf16 is held by the logit band above)."""
    _, cfg, tcfg, params, tparams = _model("float32")
    prompts = _prompts(cfg, 8, jax.random.PRNGKey(11))
    ref = _run_16_steps(
        ServeEngine(cfg, params, batch_slots=2, max_len=48, shd=SHD),
        [jnp.asarray(p) for p in prompts], Request)
    got = _run_16_steps(
        TServeEngine(tcfg, tparams, batch_slots=2, max_len=48, device="cpu"),
        [torch.from_numpy(p) for p in prompts], TRequest)
    assert got == ref
    assert all(len(toks) == 3 + rid % 4 for rid, (toks, _) in got.items())


@pytest.mark.parametrize("name", ["granite-3-8b", "qwen2-moe-a2.7b"])
def test_engine_state_keeps_its_storage(name):
    """Admissions and decode steps write the engine's tensors in place (a
    CUDA graph of the step reads and writes them at fixed addresses):
    `last_tok`, `slot_pos`, `live_mask`, `cache["index"]` and every cache
    leaf keep their storage through admissions mid-run, slots dying and
    re-admissions into the freed slots, and the tokens stay the
    reference's."""
    _, cfg, tcfg, params, tparams = _model("float32", name)
    prompts = _prompts(cfg, 8, jax.random.PRNGKey(11))
    ref = _run_16_steps(
        ServeEngine(cfg, params, batch_slots=2, max_len=48, shd=SHD),
        [jnp.asarray(p) for p in prompts], Request)
    eng = TServeEngine(tcfg, tparams, batch_slots=2, max_len=48,
                       device="cpu")

    def storage():
        leaves = []
        t_tree_map(leaves.append, eng.cache)
        return [t.data_ptr() for t in (eng.last_tok, eng.slot_pos,
                                       eng.live_mask, eng.cache["index"],
                                       *leaves)]

    index, start = eng.cache["index"], storage()
    reqs = [TRequest(i, torch.from_numpy(p), 3 + i % 4)
            for i, p in enumerate(prompts)]
    pending = list(reqs)
    slots = []
    for _ in range(16):
        while pending and eng.admit(pending[0]):
            slots.append(eng.slot_req.index(pending.pop(0)))
            assert storage() == start
        eng.step()
        assert storage() == start and eng.cache["index"] is index
    got = {r.rid: (list(r.out_tokens), r.done) for r in reqs}
    assert got == ref
    # every slot was freed and filled again, while the other one was live
    assert len(slots) == 8 and sorted(set(slots)) == [0, 1]
    assert eng.n_graph_steps == 0 and eng._graph is None


def test_batched_equals_solo(model):
    dtype, cfg, tcfg, params, tparams = model
    prompts = [torch.from_numpy(p)
               for p in _prompts(cfg, 5, jax.random.PRNGKey(5))]
    solo = []
    for i, p in enumerate(prompts):
        eng = TServeEngine(tcfg, tparams, batch_slots=1, max_len=64,
                           device="cpu")
        solo.append(eng.serve([TRequest(i, p, 6)])[0].out_tokens)
    eng = TServeEngine(tcfg, tparams, batch_slots=3, max_len=64,
                       device="cpu")
    done = eng.serve([TRequest(i, p, 6) for i, p in enumerate(prompts)])
    assert {r.rid: r.out_tokens for r in done} == dict(enumerate(solo))
    assert eng.n_prefills == 5 and eng.n_decode_steps > 0


def test_admit_errors_and_first_token_finish(model):
    dtype, cfg, tcfg, params, tparams = model
    eng = TServeEngine(tcfg, tparams, batch_slots=2, max_len=16,
                       device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.admit(TRequest(0, torch.zeros(16, dtype=torch.int32), 4))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.admit(TRequest(1, torch.zeros(4, dtype=torch.int32), 0))
    one = TRequest(2, torch.arange(4, dtype=torch.int32), 1)
    assert eng.admit(one) and one.done and len(one.out_tokens) == 1
    assert eng.n_free == 2                    # finished at admit: slot free
    assert eng.step() == 0
    assert TServeEngine(tcfg, tparams, batch_slots=1, max_len=16,
                        device="cpu").admit(
        TRequest(3, torch.arange(4), 3))


def test_temperature_sampling_is_seeded(model):
    dtype, cfg, tcfg, params, tparams = model
    runs = []
    for _ in range(2):
        eng = TServeEngine(tcfg, tparams, batch_slots=2, max_len=32,
                           temperature=1.0, seed=7, device="cpu")
        done = eng.serve([TRequest(i, torch.arange(3 + i), 5)
                          for i in range(3)])
        runs.append({r.rid: r.out_tokens for r in done})
        assert all(0 <= t < cfg.vocab_size
                   for r in done for t in r.out_tokens)
    assert runs[0] == runs[1]


@pytest.mark.parametrize("extra", [[], ["--profile"]])
def test_launch_serve_runs_on_cpu(capsys, extra):
    assert t_launch.main(["--arch", "granite-3-8b", "--reduced",
                          "--device", "cpu", "--requests", "3",
                          "--max-new", "3", *extra]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out
    assert ("device busy" in out) == bool(extra)
    assert ("ms launch + " in out and "ms sync a decode step" in out
            and "ms sync an admission" in out) == bool(extra)


def test_profile_busy_share_is_a_union_of_intervals():
    """`--profile`'s busy seconds count overlapping and nested device
    operations once (a sum of their times would count them twice)."""
    ns = 10**9
    assert t_launch.busy_seconds([(0, 2 * ns), (ns, 3 * ns), (ns, ns + 5),
                                  (5 * ns, 6 * ns)]) == pytest.approx(4.0)
    assert t_launch.busy_seconds([]) == 0.0
