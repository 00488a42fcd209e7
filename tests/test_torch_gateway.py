"""The serving gateway of the port (`repro_torch.serve.gateway`): the twins
of the 20 cases of tests/test_gateway.py on REDUCED granite-3-8b (the
reference's bf16 weights from PRNGKey(0), bridged), plus the workload
generators against the reference's draw for draw and the gateway's
decode and prefill prices against the reference gateway's.

The twins hold the port to the same properties the reference's cases
hold the reference to: the queue's order and policies, the batch
signature and plan cache, the stall budget, determinism under
`ManualClock`, the arrival-trace file, the plan-cache hit rate under
churn, prewarm, and the planner-fidelity gate on a gateway-driven
dispatch timeline. Decisions, timestamps, stats, plan-cache keys and
tokens against the reference gateway are tests/test_torch_gateway_parity.py's.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import REDUCED
from repro.models import Shardings, init_params
from repro_torch import bridge
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.dispatch import PlanCache, batch_signature
from repro_torch.dispatch import trace as dtrace
from repro_torch.serve import (AdmissionQueue, Gateway, GatewayRequest,
                               ManualClock, ServeEngine, percentile,
                               poisson_requests)

#: port / reference of a modelled price: tests/test_torch_workloads.py's
#: `WALL_REL` (the port's graphs come from its own census)
WALL_REL = 0.05


@pytest.fixture(scope="module")
def setup():
    cfg = REDUCED["granite-3-8b"]
    params = init_params(jax.random.PRNGKey(0), cfg, Shardings(None))
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
    return T_REDUCED["granite-3-8b"], tparams


def _greq(rid, plen=4, budget=4, priority=1, arrival=0.0, vocab=64):
    prompt = torch.tensor([(rid * 7 + i) % vocab for i in range(plen)],
                          dtype=torch.int32)
    return GatewayRequest(rid=rid, prompt=prompt, max_new_tokens=budget,
                          priority=priority, arrival_s=arrival)


# ------------------------------------------------------------------ #
# admission queue
# ------------------------------------------------------------------ #

def test_queue_pops_priority_then_fifo():
    q = AdmissionQueue(capacity=8)
    for rid, prio in [(0, 2), (1, 0), (2, 1), (3, 0), (4, 2)]:
        ok, shed = q.offer(_greq(rid, priority=prio))
        assert ok and shed is None
    order = [q.pop().rid for _ in range(len(q))]
    assert order == [1, 3, 2, 0, 4]     # class asc, FIFO within class
    assert q.pop() is None and q.peek() is None


def test_queue_rejects_when_full():
    q = AdmissionQueue(capacity=2, policy="reject")
    assert q.offer(_greq(0))[0] and q.offer(_greq(1))[0]
    ok, shed = q.offer(_greq(2, priority=0))
    assert not ok and shed is None and len(q) == 2


def test_queue_shed_evicts_lowest_priority_for_strictly_better():
    q = AdmissionQueue(capacity=2, policy="shed")
    q.offer(_greq(0, priority=1))
    q.offer(_greq(1, priority=2))
    # equal-to-worst priority does not shed
    ok, shed = q.offer(_greq(2, priority=2))
    assert not ok and shed is None
    # strictly better sheds the worst (class 2), newest within the class
    ok, shed = q.offer(_greq(3, priority=0))
    assert ok and shed is not None and shed.rid == 1
    assert sorted(g.rid for _, _, g in q._heap) == [0, 3]


def test_queue_validates_args():
    with pytest.raises(ValueError):
        AdmissionQueue(capacity=0)
    with pytest.raises(ValueError):
        AdmissionQueue(capacity=2, policy="drop-newest")


# ------------------------------------------------------------------ #
# batch signature + plan cache
# ------------------------------------------------------------------ #

def test_batch_signature_buckets_positions():
    a = batch_signature(2, (5, 9), pos_bucket=16)
    b = batch_signature(2, (3, 15), pos_bucket=16)
    assert a == b == ("decode", 2, 16, (), ())
    assert batch_signature(2, (16,), pos_bucket=16)[2] == 32
    assert batch_signature(3, (5,), pos_bucket=16) != a
    assert batch_signature(2, (5,), pos_bucket=16, splits=(4, 4)) != a
    assert batch_signature(1, splits=(4, 2), phase="prefill") == \
        ("prefill", 1, 64, (4, 2), ())
    with pytest.raises(ValueError):
        batch_signature(1, (), pos_bucket=0)


def test_batch_signature_keys_on_topology():
    from repro_torch.dispatch.placement import Topology
    t1, t4 = Topology(n_ranks=1), Topology(n_ranks=4)
    a1 = batch_signature(2, (5,), pos_bucket=16, topology=t1)
    a4 = batch_signature(2, (5,), pos_bucket=16, topology=t4)
    assert a1 != a4
    assert a1[-1] == ("upmem_2556", 1) and a4[-1] == ("upmem_2556", 4)
    assert batch_signature(2, (5,), pos_bucket=16,
                           topology=t4.signature) == a4
    assert batch_signature(2, (5,), pos_bucket=16,
                           topology=Topology(n_ranks=4)) == a4


def test_plan_cache_hits_misses_evictions():
    cache = PlanCache(maxsize=2)
    builds = []

    def planner(tag):
        def build():
            builds.append(tag)
            return tag
        return build

    assert cache.get_or_plan("a", planner("a")) == "a"
    assert cache.get_or_plan("a", planner("a")) == "a"   # hit, no build
    assert builds == ["a"] and "a" in cache
    cache.get_or_plan("b", planner("b"))
    cache.get_or_plan("c", planner("c"))                 # evicts "a" (LRU)
    assert "a" not in cache and len(cache) == 2
    s = cache.stats
    assert s["calls"] == 4 and s["hits"] == 1 and s["misses"] == 3
    assert s["evictions"] == 1 and s["hit_rate"] == 0.25
    with pytest.raises(ValueError):
        PlanCache(maxsize=0)


def test_percentile_nearest_rank():
    assert percentile([], 99) == 0.0
    vals = [1.0, 2.0, 3.0, 4.0]
    assert percentile(vals, 50) == 2.0
    assert percentile(vals, 99) == 4.0


# ------------------------------------------------------------------ #
# gateway integration (ManualClock: fully deterministic)
# ------------------------------------------------------------------ #

def _gateway(cfg, params, *, slots=3, max_len=48, tick=1e-3, **kw):
    eng = ServeEngine(cfg, params, batch_slots=slots, max_len=max_len,
                      device="cpu")
    return Gateway(eng, clock=ManualClock(tick=tick), pos_bucket=16, **kw)


def test_gateway_completes_all_under_capacity(setup):
    cfg, params = setup
    gw = _gateway(cfg, params, queue_capacity=16)
    reqs = poisson_requests(8, 100.0, seed=3, vocab=cfg.vocab_size,
                            prompt_lens=(3, 8), max_new=(2, 6))
    stats = gw.run(reqs)
    assert stats.completed == 8 and stats.rejected == 0
    assert stats.offered == 8
    assert stats.tokens == sum(len(g.out_tokens) for g in gw.finished)
    for g in gw.finished:
        assert g.state == "done"
        assert len(g.out_tokens) == g.request.max_new_tokens \
            or g.request.done
        assert g.ttft_s is not None and g.ttft_s >= 0.0
        assert len(g.token_times) == len(g.out_tokens)
    assert stats.sustained_rps > 0 and stats.duration_s > 0


def test_gateway_rejects_under_overload(setup):
    cfg, params = setup
    gw = _gateway(cfg, params, slots=1, queue_capacity=2)
    reqs = [_greq(i, arrival=0.0, vocab=cfg.vocab_size) for i in range(8)]
    stats = gw.run(reqs)
    assert stats.rejected > 0
    assert stats.completed + stats.rejected == stats.offered == 8
    assert all(g.reject_reason == "queue-full" for g in gw.rejected)
    assert all(g.state == "rejected" for g in gw.rejected)


def test_gateway_shed_policy_prefers_interactive(setup):
    cfg, params = setup
    gw = _gateway(cfg, params, slots=1, queue_capacity=2,
                  shed_policy="shed")
    reqs = [_greq(i, priority=2, vocab=cfg.vocab_size) for i in range(4)]
    reqs += [_greq(10 + i, priority=0, vocab=cfg.vocab_size)
             for i in range(2)]
    stats = gw.run(reqs)
    assert stats.shed > 0
    assert all(g.priority == 2 for g in gw.rejected)
    assert all(g.priority == 0 for g in gw.finished
               if g.rid >= 10) and any(g.rid >= 10 for g in gw.finished)


def test_gateway_admits_in_priority_order(setup):
    cfg, params = setup
    gw = _gateway(cfg, params, slots=1, queue_capacity=16)
    reqs = [_greq(0, priority=2), _greq(1, priority=0),
            _greq(2, priority=1), _greq(3, priority=0)]
    gw.run(reqs)
    admitted = sorted(gw.finished, key=lambda g: g.admit_s)
    assert [g.rid for g in admitted] == [1, 3, 2, 0]


def test_gateway_rejects_invalid_payloads(setup):
    cfg, params = setup
    gw = _gateway(cfg, params, max_len=48)
    long = _greq(0, plen=48)
    bad = _greq(1, budget=0)
    assert not gw.submit(long) and long.reject_reason == "prompt-too-long"
    assert not gw.submit(bad) and bad.reject_reason == "bad-budget"
    assert gw.stats().rejected == 2


def test_gateway_budget_one_finishes_at_admit(setup):
    cfg, params = setup
    gw = _gateway(cfg, params)
    greq = _greq(0, budget=1, vocab=cfg.vocab_size)
    stats = gw.run([greq])
    assert stats.completed == 1
    assert greq.state == "done" and len(greq.out_tokens) == 1
    assert len(greq.token_times) == 1 and gw.engine.n_free == 3


def test_stall_budget_caps_admissions_per_gap(setup):
    cfg, params = setup
    gw = _gateway(cfg, params, slots=3, queue_capacity=8, max_stall_s=0.0)
    for i in range(3):
        assert gw.submit(_greq(i, budget=6, vocab=cfg.vocab_size))
    # zero budget: one admission per decode gap (never starves)
    assert gw.admit_pending() == 1
    assert gw.admit_pending() == 1
    gw2 = _gateway(cfg, params, slots=3, queue_capacity=8,
                   max_stall_s=1e9)
    for i in range(3):
        assert gw2.submit(_greq(i, budget=6, vocab=cfg.vocab_size))
    assert gw2.admit_pending() == 3


def test_gateway_seeded_poisson_deterministic(setup):
    cfg, params = setup

    def one_run():
        gw = _gateway(cfg, params, queue_capacity=16)
        reqs = poisson_requests(6, 80.0, seed=21, vocab=cfg.vocab_size,
                                prompt_lens=(3, 8), max_new=(2, 5))
        stats = gw.run(reqs)
        return ({g.rid: g.out_tokens for g in gw.finished},
                {g.rid: (g.arrival_s, g.admit_s, tuple(g.token_times))
                 for g in gw.finished},
                (stats.completed, stats.steps, stats.tokens))

    assert one_run() == one_run()
    other = poisson_requests(6, 80.0, seed=22, vocab=cfg.vocab_size)
    base = poisson_requests(6, 80.0, seed=21, vocab=cfg.vocab_size)
    assert [g.arrival_s for g in other] != [g.arrival_s for g in base]


def test_arrival_trace_round_trip(setup, tmp_path):
    cfg, params = setup
    from repro_torch.serve import load_arrival_trace, save_arrival_trace
    path = tmp_path / "arrivals.jsonl"
    reqs = poisson_requests(6, 80.0, seed=21, vocab=cfg.vocab_size,
                            prompt_lens=(3, 8), max_new=(2, 5))
    assert save_arrival_trace(path, reqs) == 6
    loaded = load_arrival_trace(path, seed=9, vocab=cfg.vocab_size)
    assert [g.arrival_s for g in loaded] == [g.arrival_s for g in reqs]
    assert [int(g.prompt.shape[0]) for g in loaded] == \
        [int(g.prompt.shape[0]) for g in reqs]
    assert [g.max_new_tokens for g in loaded] == \
        [g.max_new_tokens for g in reqs]
    assert [g.priority for g in loaded] == [g.priority for g in reqs]

    def one_run():
        gw = _gateway(cfg, params, queue_capacity=16)
        stats = gw.run(load_arrival_trace(path, seed=9,
                                          vocab=cfg.vocab_size))
        return ({g.rid: g.out_tokens for g in gw.finished},
                {g.rid: (g.arrival_s, tuple(g.token_times))
                 for g in gw.finished}, stats.completed)

    a = one_run()
    assert a == one_run() and a[2] == 6
    alt = load_arrival_trace(path, seed=10, vocab=cfg.vocab_size)
    assert [g.arrival_s for g in alt] == [g.arrival_s for g in reqs]
    assert any(g.prompt.tolist() != h.prompt.tolist()
               for g, h in zip(alt, loaded))
    path2 = tmp_path / "hand.jsonl"
    path2.write_text(
        "# fleet replay\n\n"
        '{"arrival_s": 0.5, "prompt_len": 4, "max_new": 2, "class": 0}\n'
        '{"arrival_s": 1.0, "prompt_len": 3, "max_new": 3,'
        ' "class": "batch"}\n')
    hand = load_arrival_trace(path2, vocab=cfg.vocab_size)
    assert [(g.rid, g.arrival_s, g.priority) for g in hand] == \
        [(0, 0.5, 0), (1, 1.0, 2)]


def test_gateway_plan_cache_hit_rate_across_churn(setup):
    cfg, params = setup
    gw = _gateway(cfg, params, slots=3, queue_capacity=32, tick=1e-4)
    gw.pos_bucket = 8
    reqs = poisson_requests(20, 150.0, seed=5, vocab=cfg.vocab_size,
                            prompt_lens=(3, 10), max_new=(2, 8))
    stats = gw.run(reqs)
    assert stats.completed == 20
    pc = stats.plan_cache
    assert pc["hit_rate"] > 0.80, pc
    # distinct signatures each solved exactly once (no double builds)
    assert pc["misses"] == pc["size"] + pc["evictions"]


def test_gateway_prewarm_primes_the_cache(setup):
    cfg, params = setup
    gw = _gateway(cfg, params, slots=2, max_len=32)
    warm = gw.prewarm(prompt_lens=(4, 5, 6))
    assert warm["misses"] > 0 and warm["hits"] == 0
    reqs = poisson_requests(4, 100.0, seed=9, vocab=cfg.vocab_size,
                            prompt_lens=(4, 6), max_new=(2, 4))
    stats = gw.run(reqs)
    assert stats.plan_cache["misses"] == warm["misses"]


# ------------------------------------------------------------------ #
# dispatch engine: gateway-driven timeline through the fidelity gate
# ------------------------------------------------------------------ #

def test_gateway_dispatch_fidelity_replay(setup):
    cfg, params = setup
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=48, device="cpu",
                      engine="dispatch",
                      dispatch_kwargs={"prefill_chunk": 4})
    tracer = dtrace.Trace("gateway-test")
    gw = Gateway(eng, queue_capacity=8, pos_bucket=16,
                 clock=ManualClock(tick=1e-3))
    gw.attach_tracer(tracer)
    reqs = poisson_requests(4, 100.0, seed=5, vocab=cfg.vocab_size,
                            prompt_lens=(4, 5), max_new=(3, 5))
    stats = gw.run(reqs)
    assert stats.completed == 4
    assert len(tracer.by_kind("decode_step")) == stats.steps
    assert len(tracer.by_kind("prefill_step")) == 4
    rep = dtrace.fidelity(eng._dispatch_decode.dag, eng._dispatch_decode.plan,
                          trace=tracer)
    assert rep.ok, rep.render()
    ec = eng._dispatch_prefill.executor_cache.stats
    assert ec["calls"] >= 4 and ec["hits"] >= 1


# ------------------------------------------------------------------ #
# against the reference: workload generators and prices
# ------------------------------------------------------------------ #

def _shape(reqs):
    return [(g.rid, g.arrival_s, g.prompt.tolist(), g.max_new_tokens,
             g.priority) for g in reqs]


@pytest.mark.parametrize("kw", [
    dict(n=8, rate_rps=100.0, seed=3, prompt_lens=(3, 8), max_new=(2, 6)),
    dict(n=20, rate_rps=150.0, seed=5, prompt_lens=(3, 10), max_new=(2, 8)),
    dict(n=16, rate_rps=1.6, seed=0, vocab=49155,
         prompt_lens=(64, 1500), max_new=(32, 32), priorities=(1,),
         weights=(1,), start_s=2.5),
])
def test_poisson_requests_draw_for_draw(kw):
    from repro.serve import poisson_requests as j_poisson
    kw = dict(kw)
    n, rate = kw.pop("n"), kw.pop("rate_rps")
    assert _shape(poisson_requests(n, rate, **kw)) == \
        _shape(j_poisson(n, rate, **kw))


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_arrival_trace_crosses_packages(tmp_path, writer):
    """A trace saved by one package loads in the other, and both loaders
    draw the same prompt tokens from one seed."""
    from repro.serve import load_arrival_trace as j_load
    from repro.serve import poisson_requests as j_poisson
    from repro.serve import save_arrival_trace as j_save
    from repro_torch.serve import load_arrival_trace, save_arrival_trace
    path = tmp_path / "arrivals.jsonl"
    if writer == "reference":
        j_save(path, j_poisson(9, 40.0, seed=4, prompt_lens=(2, 30)))
    else:
        save_arrival_trace(path, poisson_requests(9, 40.0, seed=4,
                                                  prompt_lens=(2, 30)))
    text = path.read_text()
    other = tmp_path / "other.jsonl"
    (j_save if writer == "port" else save_arrival_trace)(
        other, (j_load if writer == "port" else load_arrival_trace)(path))
    assert other.read_text() == text
    assert _shape(load_arrival_trace(path, seed=7, vocab=500)) == \
        _shape(j_load(path, seed=7, vocab=500))


def _gateways(slots=3, max_len=48, **engine_kwargs):
    """A reference gateway and the port's over the REDUCED granite
    engines (the reference's fused engine; the prices need no forward)."""
    from repro.serve import Gateway as JGateway
    from repro.serve import ServeEngine as JServeEngine
    cfg = REDUCED["granite-3-8b"]
    tcfg = T_REDUCED["granite-3-8b"]
    jeng = JServeEngine(cfg, _j_params(), batch_slots=slots,
                        max_len=max_len, shd=Shardings(None))
    teng = ServeEngine(tcfg, _t_params(), batch_slots=slots,
                       max_len=max_len, device="cpu", **engine_kwargs)
    return (JGateway(jeng, pos_bucket=16, clock=ManualClock(tick=1e-3)),
            Gateway(teng, pos_bucket=16, clock=ManualClock(tick=1e-3)))


@functools.cache
def _j_params():
    return init_params(jax.random.PRNGKey(0), REDUCED["granite-3-8b"],
                       Shardings(None))


@functools.cache
def _t_params():
    return bridge.params_from_numpy(jax.tree.map(np.asarray, _j_params()),
                                    device="cpu")


@pytest.mark.parametrize("n_live,pos", [(1, 3), (2, 17), (3, 40)])
def test_decode_price_within_the_workloads_band(n_live, pos):
    jgw, tgw = _gateways()
    key = batch_signature(n_live, (pos,), pos_bucket=16)
    j = jgw._price_decode(n_live, key[2])
    t = tgw._price_decode(n_live, key[2])
    assert t.priced_s == pytest.approx(j.priced_s, rel=WALL_REL)
    assert t.plan.assignment == j.plan.assignment
    assert t.plan.method == j.plan.method


@pytest.mark.parametrize("plen", [4, 9, 30])
def test_prefill_price_within_the_workloads_band(plen):
    jgw, tgw = _gateways()
    j, t = jgw.prefill_price_s(plen), tgw.prefill_price_s(plen)
    assert t == pytest.approx(j, rel=WALL_REL)
    # the keys are pure integers: equal in both caches
    assert list(tgw.plans._entries) == list(jgw.plans._entries)
