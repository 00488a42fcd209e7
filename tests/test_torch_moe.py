"""The port's MoE layer, its int8 expert route and MoE serving against the
reference's, on REDUCED mixtral-8x7b (4 experts top-2, window 16) and
qwen2-moe-a2.7b (6 experts top-2, 2 shared experts behind a sigmoid gate),
with the reference's weights (bridged) and inputs drawn from a numpy seed.

Tolerances: the dispatch is exact (buffer, expert ids and positions equal;
gate weights and softmax to 1e-6 at f32, 1e-2 at bf16, where the router
reads bf16 activations); int8 weights, scales and int32 accumulators are
equal bit for bit; layer outputs as in tests/test_torch_layers.py (f32
1e-5, bf16 3e-2 of the output's scale); model logits at
tests/test_torch_serve.py's LOGIT_TOL and the aux loss within 1e-6 at
f32, 5e-3 at bf16 (where a top-k choice flips, see the forward test);
serving parity is token identity at f32, with int8
experts too."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import REDUCED
from repro.models import Shardings, forward, init_cache, init_params
from repro.models import layers as JL
from repro.serve import Request, ServeEngine
from repro_torch import bridge
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.launch import serve as t_launch
from repro_torch.models import forward as t_forward
from repro_torch.models import init_cache as t_init_cache
from repro_torch.models import layers as TL
from repro_torch.models import quantize_moe_params
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine

SHD = Shardings(None)
MOE = ["mixtral-8x7b", "qwen2-moe-a2.7b"]
DTYPES = ["float32", "bfloat16"]
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 6e-2}
LAYER_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
GATE_TOL = {"float32": 1e-6, "bfloat16": 1e-2}
AUX_TOL = {"float32": 1e-6, "bfloat16": 5e-3}


@functools.cache
def _model(name, dtype, quant=""):
    cfg = dataclasses.replace(REDUCED[name], dtype=dtype, quant=quant)
    tcfg = dataclasses.replace(T_REDUCED[name], dtype=dtype, quant=quant)
    params = init_params(jax.random.PRNGKey(0), cfg, SHD)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
    return cfg, tcfg, params, tparams


@functools.cache
def _jit_forward(name, dtype):
    """The reference's `forward` with a cache, jitted once per model."""
    cfg = _model(name, dtype)[0]
    return jax.jit(lambda p, toks, cache: forward(p, cfg, SHD, tokens=toks,
                                                  cache=cache))


def _layer(params, i=0):
    """Block i of the first MoE pattern position: (numpy tree, tensors)."""
    jp = jax.tree.map(lambda a: np.asarray(a[i]), params["layers"][0]["mlp"])
    return jp, bridge.params_from_numpy(jp, device="cpu")


def _x(cfg, dtype, s, seed=3, skew=0.0):
    """(2, s, d) activations in `dtype`, as the same bits on both sides.
    `skew` adds one shared direction to every token, which tilts the router
    toward a few experts so that their capacity overflows."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, s, cfg.d_model))
    x = (x + skew * rng.normal(size=cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    return xj, bridge.tensor_from_numpy(np.asarray(xj), "cpu")


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _bits(t):
    """A tensor's values as numpy, bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


# ------------------------------------------------------------------ #
# the layer's pieces
# ------------------------------------------------------------------ #

@pytest.mark.parametrize("s,skew", [(1, 0.0), (7, 0.0), (48, 3.0)],
                         ids=["decode", "prefill", "prefill-drops"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE)
def test_moe_dispatch(name, dtype, s, skew):
    cfg, tcfg, params, _ = _model(name, dtype)
    jp, tp = _layer(params)
    xj, xt = _x(cfg, dtype, s, skew=skew)
    jbuf, jtopi, jpos, jw, jgates = JL.moe_dispatch(xj, jp["router"], cfg)
    buf, topi, pos, w, gates = TL.moe_dispatch(xt, tp["router"], tcfg)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    assert buf.dtype == xt.dtype and tuple(buf.shape) == jbuf.shape
    np.testing.assert_array_equal(_bits(buf), _jbits(jbuf))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                               atol=GATE_TOL[dtype])
    np.testing.assert_allclose(gates.numpy(), np.asarray(jgates), rtol=0,
                               atol=GATE_TOL[dtype])
    cap = buf.shape[2]
    dropped = pos >= cap
    assert bool(dropped.any()) or not skew, "no token was dropped"
    assert bool((w[dropped] == 0).all())


def test_dispatch_rows_keep_their_own_capacity():
    """Positions count within a batch row: a row's tokens fill its own
    capacity whatever the other rows route, as dead serving slots must
    not take a live slot's capacity."""
    cfg, tcfg, _, tparams = _model("mixtral-8x7b", "float32")
    router = tparams["layers"][0]["mlp"]["router"][0]
    x = torch.randn(1, 30, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    alone = TL.moe_dispatch(x, router, tcfg)
    crowd = torch.cat([x, x.flip(1) * 3, torch.zeros_like(x)])
    batched = TL.moe_dispatch(crowd, router, tcfg)
    for a, b in zip(alone, batched):
        assert torch.equal(a[0], b[0])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE)
def test_quantize_q8_bit_identical(name, dtype):
    cfg, tcfg, params, tparams = _model(name, dtype)
    jp, tp = _layer(params)
    stacked = tparams["layers"][0]["mlp"]
    for w in ("wu", "wg", "wd"):
        jq, js = JL.quantize_q8(jnp.asarray(jp[w]))
        q, scale = TL.quantize_q8(tp[w])
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
        # the stacked weights quantized at once (axis 2) give block 0's
        q2, s2 = TL.quantize_q8(stacked[w], axis=2)
        assert torch.equal(q2[0], q) and torch.equal(s2[0], scale)
    rows = np.random.default_rng(5).normal(size=(3, 4, 5, 16))
    rows[0, 1, 2] = 0.0                   # amax = 0: scale 1, zeros out
    rows = rows.astype(np.float32)
    jq, js = JL._quantize_rows(jnp.asarray(rows))
    q, scale = TL._quantize_rows(torch.from_numpy(rows))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(js))
    assert float(scale[0, 1, 2, 0]) == 1.0


@pytest.mark.parametrize("s", [1, 48])
@pytest.mark.parametrize("name", MOE)
def test_int8_accumulators_exact(name, s):
    """The int8 x int8 contraction on the reference's own int8 operands
    (a real dispatch buffer's rows, the layer's weights) equals its int32
    accumulators, for the up and the down projection's shapes."""
    cfg, tcfg, params, _ = _model(name, "float32")
    jp, _ = _layer(params)
    xj, _ = _x(cfg, "float32", s, skew=1.0)
    buf = JL.moe_dispatch(xj, jnp.asarray(jp["router"]), cfg)[0]
    xq, _ = JL._quantize_rows(buf)
    for w in ("wu", "wd"):
        wq, _ = JL.quantize_q8(jnp.asarray(jp[w]))
        lhs = xq
        if w == "wd":                     # rows of the expert width
            lhs = jnp.asarray(np.random.default_rng(1).integers(
                -127, 128, buf.shape[:3] + (wq.shape[1],)), jnp.int8)
        want = jnp.einsum("becd,edf->becf", lhs, wq,
                          preferred_element_type=jnp.int32)
        got = TL.int8_expert_matmul(torch.from_numpy(np.array(lhs)),
                                    torch.from_numpy(np.array(wq)))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # extreme operands: |sum| = 127^2 K, still exact in int32
    big = torch.full((1, 2, 3, 2048), -127, dtype=torch.int8)
    wbig = torch.full((2, 2048, 8), -127, dtype=torch.int8)
    assert bool((TL.int8_expert_matmul(big, wbig) == 127 * 127 * 2048).all())


def test_int8_matmul_rejects_and_counts_nothing_on_the_cpu():
    xq = torch.zeros((1, 2, 3, 16), dtype=torch.int8)
    wq = torch.zeros((2, 16, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="int8"):
        TL.int8_expert_matmul(xq.float(), wq)
    with pytest.raises(ValueError, match="match"):
        TL.int8_expert_matmul(xq, wq[:1])
    TL.EXPERT_MM.reset()
    TL.int8_expert_matmul(xq, wq)
    assert TL.EXPERT_MM.launches == 0 and not TL.EXPERT_MM.route_launches


@pytest.mark.parametrize("name", MOE)
def test_expert_ffn_q8(name):
    cfg, tcfg, params, _ = _model(name, "float32", "int8")
    jp, tp = _layer(params)
    xj, xt = _x(cfg, "float32", 9, skew=1.0)
    buf = JL.moe_dispatch(xj, jnp.asarray(jp["router"]), cfg)[0]
    tbuf = TL.moe_dispatch(xt, tp["router"], tcfg)[0]
    want = JL.moe_expert_ffn(buf, jax.tree.map(jnp.asarray, jp), cfg, SHD)
    got = TL.moe_expert_ffn(tbuf, tp, tcfg)
    _close(got, want, LAYER_TOL["float32"])
    # weights quantized ahead give the same bits as quantized in the body
    ahead = TL.moe_expert_ffn(tbuf, dict(tp, q8=TL.quantize_experts(tp)),
                              tcfg)
    assert torch.equal(ahead, got)


@pytest.mark.parametrize("dtype,quant", [("float32", ""), ("bfloat16", ""),
                                         ("float32", "int8"),
                                         ("bfloat16", "int8")])
@pytest.mark.parametrize("name", MOE)
def test_moe_forward_and_combine(name, dtype, quant):
    cfg, tcfg, params, _ = _model(name, dtype, quant)
    jp, tp = _layer(params)
    xj, xt = _x(cfg, dtype, 24, skew=2.0)
    jy, jaux = JL.moe_forward(xj, jax.tree.map(jnp.asarray, jp), cfg, SHD)
    y, aux = TL.moe_forward(xt, tp, tcfg)
    assert y.dtype == xt.dtype and aux.dtype == torch.float32
    _close(y, jy, LAYER_TOL[dtype])
    assert abs(float(aux) - float(jaux)) <= AUX_TOL[dtype]
    # the combine alone, on one expert-output buffer
    jbuf, jtopi, jpos, jw, _ = JL.moe_dispatch(xj, jnp.asarray(jp["router"]),
                                               cfg)
    jc = JL.moe_combine(jbuf * 2, jtopi, jpos, jw, xj.dtype)
    buf, topi, pos, w, _ = TL.moe_dispatch(xt, tp["router"], tcfg)
    _close(TL.moe_combine(buf * 2, topi, pos, w, xt.dtype), jc,
           LAYER_TOL[dtype])


class _Products(TorchDispatchMode):
    """Records the operand dtypes of every matrix product run under it."""

    OPS = {torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
           torch.ops.aten.baddbmm}

    def __init__(self):
        super().__init__()
        self.dtypes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.OPS:
            self.dtypes.append({a.dtype for a in args
                                if isinstance(a, torch.Tensor)})
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", MOE)
def test_moe_products_run_in_the_models_dtype(name):
    """At bf16 the expert and shared-expert products take bf16 operands and
    only the router and the shared gate run in f32, as the reference's
    einsums do: a layer computed in f32 and cast back fails here, which
    the logit tolerances alone would let through."""
    cfg, tcfg, params, _ = _model(name, "bfloat16")
    _, tp = _layer(params)
    _, xt = _x(cfg, "bfloat16", 7)
    with _Products() as rec:
        y, _ = TL.moe_forward(xt, tp, tcfg)
    assert y.dtype == torch.bfloat16
    n_f32 = 1 + bool(cfg.n_shared_experts)     # router, shared gate
    n_bf16 = (3 if cfg.gated_mlp else 2) * (1 + bool(cfg.n_shared_experts))
    assert sorted(rec.dtypes, key=str) == sorted(
        [{torch.float32}] * n_f32 + [{torch.bfloat16}] * n_bf16, key=str), \
        rec.dtypes


# ------------------------------------------------------------------ #
# the model and the serving engine
# ------------------------------------------------------------------ #

def _record_topi(monkeypatch, rec, trec):
    """Record every MoE layer's expert choices, in layer order: the
    reference's bf16 traces into `rec` (through an ordered debug callback,
    so its jitted scan reports each layer), the port's into `trec`."""
    ref_dispatch, port_dispatch = JL.moe_dispatch, TL.moe_dispatch

    def ref_hook(x, router, cfg):
        out = ref_dispatch(x, router, cfg)
        if x.dtype == jnp.bfloat16:
            jax.debug.callback(lambda t: rec.append(np.asarray(t)), out[1],
                               ordered=True)
        return out

    def port_hook(x, router, cfg, *shd):
        out = port_dispatch(x, router, cfg, *shd)
        trec.append(out[1].numpy())
        return out

    monkeypatch.setattr(JL, "moe_dispatch", ref_hook)
    monkeypatch.setattr(TL, "moe_dispatch", port_hook)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", MOE)
def test_forward_prefill_and_16_decode_steps(name, dtype, monkeypatch):
    """Prefill + 16 decode steps, teacher-forced on the reference's f32
    greedy tokens. f32: logits within LOGIT_TOL, aux within 1e-6, every
    step. bf16: every layer's expert choices are recorded on both sides.
    On a step where they agree, the logits are held to LOGIT_TOL and the
    aux to AUX_TOL. A top-k choice can flip between two bf16 runs
    (measured: one expert of one token in a layer, moving the logits by up
    to 0.14 of their scale and the aux by ~2% of its value), so on a step
    where a choice differs the port's logits must be no further from the
    f32 reference than the reference's own bf16 logits are, and its aux
    within 5% of the f32 reference's; such steps stay rare (at most 4 of
    17; measured 1 and 2). The bf16 logits must also differ
    from the f32 reference by more than f32's LOGIT_TOL: a model computed
    in f32 fails."""
    cfg, tcfg, params, tparams = _model(name, dtype)
    cfg32, _, params32, _ = _model(name, "float32")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 21)).astype(np.int32)
    jc, fc = init_cache(cfg, 2, 48), init_cache(cfg32, 2, 48)
    tc = t_init_cache(tcfg, 2, 48, device="cpu")
    ref32 = _jit_forward(name, "float32")
    rec, trec = [], []
    if dtype == "float32":
        ref = _jit_forward(name, dtype)
    else:
        _record_topi(monkeypatch, rec, trec)
        ref = jax.jit(lambda p, t, c: forward(p, cfg, SHD, tokens=t, cache=c))
    flipped = 0
    for step in range(17):
        rec.clear()
        trec.clear()
        jl, jc, ja = ref(params, jnp.asarray(toks), jc)
        jax.effects_barrier()
        fl, fc, fa = ref32(params32, jnp.asarray(toks), fc)
        tl, tc, ta = t_forward(tparams, tcfg, tokens=torch.from_numpy(toks),
                               cache=tc)
        v = cfg.vocab_size
        want = np.asarray(jl, np.float32)[..., :v]
        f32 = np.asarray(fl, np.float32)[..., :v]
        got = tl.float().numpy()[..., :v]
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        aux_err = abs(float(ta) - float(ja))
        same = dtype == "float32"
        if not same:
            assert len(rec) == len(trec) == cfg.n_blocks, (len(rec), len(trec))
            same = all(np.array_equal(a, b) for a, b in zip(rec, trec))
            flipped += not same
            assert np.abs(got - f32).max() > LOGIT_TOL["float32"] * scale
        if same:
            assert err <= LOGIT_TOL[dtype] * scale, (step, err / scale)
            assert aux_err <= AUX_TOL[dtype], (step, aux_err)
        else:
            assert (err <= LOGIT_TOL[dtype] * scale
                    or np.abs(got - f32).max() <= np.abs(want - f32).max()), \
                (step, err / scale)
            assert abs(float(ta) - float(fa)) <= 0.05 * float(fa), step
        assert ta.dtype == torch.float32 and float(ta) > 0
        toks = np.asarray(jnp.argmax(fl[:, -1], -1))[:, None].astype(np.int32)
    assert int(tc["index"]) == int(jc["index"]) == 21 + 16
    assert flipped <= 4, f"choices differ on {flipped} of 17 steps"


def _prompts(cfg, n, key):
    """tests/test_serve.py's prompt draw, as numpy."""
    out = []
    for _ in range(n):
        key, k = jax.random.split(key)
        plen = 3 + int(jax.random.randint(k, (), 0, 8))
        out.append(np.array(jax.random.randint(
            k, (plen,), 0, cfg.vocab_size, dtype=jnp.int32)))
    return out


def _run_16_steps(eng, prompts, make_request):
    """tests/test_serve.py's 16-step continuous-batching schedule with
    arrivals and evictions; {rid: (tokens, done)}."""
    reqs = [make_request(i, p, 3 + i % 4) for i, p in enumerate(prompts)]
    pending = list(reqs)
    for _ in range(16):
        while pending and eng.admit(pending[0]):
            pending.pop(0)
        eng.step()
    return {r.rid: (list(r.out_tokens), r.done) for r in reqs}


def _serve_both(name, quant):
    cfg, tcfg, params, tparams = _model(name, "float32", quant)
    prompts = _prompts(cfg, 8, jax.random.PRNGKey(11))
    ref = _run_16_steps(
        ServeEngine(cfg, params, batch_slots=2, max_len=48, shd=SHD),
        [jnp.asarray(p) for p in prompts], Request)
    eng = TServeEngine(tcfg, tparams, batch_slots=2, max_len=48,
                       device="cpu")
    return ref, _run_16_steps(eng, [torch.from_numpy(p) for p in prompts],
                              TRequest), eng


@pytest.mark.parametrize("name", MOE)
def test_serve_token_identical_to_reference(name):
    ref, got, eng = _serve_both(name, "")
    assert got == ref
    assert all(len(toks) == 3 + rid % 4 for rid, (toks, _) in got.items())
    assert "q8" not in eng.params["layers"][0]["mlp"]


def test_serve_int8_token_identical_to_reference():
    """tests/test_quant.py's int8 model: the engine quantizes the experts
    once, and serves token for token what the reference's fused engine
    serves with its in-jit quantization."""
    ref, got, eng = _serve_both("mixtral-8x7b", "int8")
    assert got == ref
    q8 = eng.params["layers"][0]["mlp"]["q8"]
    assert sorted(q8) == ["wd", "wg", "wu"]
    assert all(q.dtype == torch.int8 for q, _ in q8.values())


def test_int8_logits_bounded_error_vs_f32():
    """tests/test_quant.py's accuracy gate on the port: int8 experts change
    the logits, by less than 0.05."""
    _, t8, _, tparams = _model("mixtral-8x7b", "float32", "int8")
    t32 = dataclasses.replace(t8, quant="")
    toks = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.PRNGKey(7), (2, 8), 0, t8.vocab_size, dtype=jnp.int32)))
    last = {}
    for cfg in (t32, t8):
        logits, _, _ = t_forward(tparams, cfg, tokens=toks,
                                 cache=t_init_cache(cfg, 2, 32, device="cpu"))
        last[cfg.quant] = logits[:, -1]
    err = float((last[""] - last["int8"]).abs().max())
    assert 0.0 < err < 0.05


@pytest.mark.parametrize("name", MOE)
def test_quantized_once_equals_quantized_in_forward(name):
    """Weights quantized once for the engine and weights quantized in every
    forward give bit-identical logits, at prefill and decode."""
    _, tcfg, _, tparams = _model(name, "float32", "int8")
    ahead = quantize_moe_params(tparams, tcfg)
    q8 = ahead["layers"][0]["mlp"]["q8"]
    for blk in range(tcfg.n_blocks):
        one = TL.quantize_experts({n: t[blk] for n, t in
                                   tparams["layers"][0]["mlp"].items()
                                   if n in ("wu", "wg", "wd")})
        for n, (q, scale) in one.items():
            assert torch.equal(q8[n][0][blk], q)
            assert torch.equal(q8[n][1][blk], scale)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 13)))
    outs = []
    for p in (ahead, tparams):
        cache = t_init_cache(tcfg, 2, 32, device="cpu")
        logits, cache, aux = t_forward(p, tcfg, tokens=toks, cache=cache)
        step, cache, aux2 = t_forward(p, tcfg, tokens=toks[:, :1],
                                      cache=cache)
        outs.append((logits, step, aux, aux2))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", MOE)
def test_param_tree_is_the_engine_tree(name):
    """Only the int8 engine adds leaves, and only `q8` under MoE layers;
    every other leaf is the caller's tensor, not a copy."""
    _, tcfg, _, tparams = _model(name, "float32", "int8")
    ahead = quantize_moe_params(tparams, tcfg)
    for lp, lq in zip(tparams["layers"], ahead["layers"]):
        assert set(lq["mlp"]) - set(lp["mlp"]) == {"q8"}
        assert all(lq["mlp"][n] is lp["mlp"][n] for n in lp["mlp"])
        assert lq["attn"] is lp["attn"]
    assert ahead["embed"] is tparams["embed"]


@pytest.mark.parametrize("arch", MOE)
def test_launch_serve_runs_moe_on_cpu(capsys, arch):
    assert t_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--requests", "3", "--max-new", "3"]) == 0
    assert "3 requests, 9 tokens" in capsys.readouterr().out
