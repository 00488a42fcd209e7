"""RWKV-6 in the port against `repro`, on REDUCED rwkv6-3b with the
reference's weights (bridged) and inputs drawn with numpy from a seed.

Tolerances: f32 logits and layer outputs within 1e-4 of their scale (the
order of f32 sums differs); the twins of tests/test_models.py at its own
tolerances (2e-2, and 1e-4 for chunked against per-token); serving is
token identity at f32. The helpers here serve the other zoo files too
(tests/test_torch_zoo_{jamba,whisper,mrope}.py)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED
from repro.models import Shardings, forward, init_cache, init_params
from repro.models import rwkv as JR
from repro.serve import Request, ServeEngine
from repro_torch import bridge
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.launch import serve as t_launch
from repro_torch.models import forward as t_forward
from repro_torch.models import init_cache as t_init_cache
from repro_torch.models import rwkv as TR
from repro_torch.serve import Request as TRequest
from repro_torch.serve import ServeEngine as TServeEngine
from test_torch_dispatch_serve import prompts, run_16_steps

SHD = Shardings(None)
TOL = 1e-4
NAME = "rwkv6-3b"


# --------------------------------------------------------------------- #
# helpers shared by the zoo files
# --------------------------------------------------------------------- #

@functools.cache
def zoo_model(name, dtype="float32", seed=0):
    """(cfg, tcfg, params, tparams): REDUCED `name` in `dtype`, the
    reference's weights and the same weights bridged to the CPU."""
    cfg = dataclasses.replace(REDUCED[name], dtype=dtype)
    tcfg = dataclasses.replace(T_REDUCED[name], dtype=dtype)
    params = init_params(jax.random.PRNGKey(seed), cfg, SHD)
    tparams = bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                       device="cpu")
    return cfg, tcfg, params, tparams


@functools.cache
def jit_forward(cfg):
    """The reference's forward, jitted (eager, it re-traces its scans on
    every call)."""
    return jax.jit(lambda params, **kw: forward(params, cfg, SHD, **kw))


def to_jax(a):
    return jnp.asarray(a)


def to_torch(a):
    a = np.asarray(a)
    t = torch.from_numpy(a.copy())
    return t.long() if a.dtype.kind == "i" else t


def close(got, want, tol=TOL):
    """max |got - want| <= tol * max |want| (over the real vocab for
    logits: pass them through `real`)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max err {err:.3g} > {tol} x {scale:.3g}"


def real(logits, cfg):
    return logits[..., :cfg.vocab_size]


def check_forward_prefill_decode(name, inputs, s_pre, steps=4):
    """`inputs` (numpy; `tokens` (B,S) or `embeds`, plus any of
    `encoder_embeds`, `mrope_positions`): the full forward, a prefill of
    the first `s_pre` positions into a cache and `steps` decode steps on
    tokens drawn from a seed, each side's logits within TOL of the
    other's. Returns the two final caches."""
    cfg, tcfg, params, tparams = zoo_model(name)
    fwd = jit_forward(cfg)

    def both(j_kw, t_kw, jc=None, tc=None):
        jl, jc, _ = fwd(params, cache=jc, **{k: to_jax(v)
                                             for k, v in j_kw.items()})
        tl, tc, _ = t_forward(tparams, tcfg, cache=tc,
                              **{k: to_torch(v) for k, v in t_kw.items()})
        close(real(tl, cfg), real(np.asarray(jl), cfg))
        return jc, tc

    both(inputs, inputs)
    pre = {}
    for k, v in inputs.items():
        if k in ("tokens", "embeds"):
            pre[k] = v[:, :s_pre]
        elif k == "mrope_positions":
            pre[k] = v[:, :, :s_pre]
        else:
            pre[k] = v
    b = next(iter(inputs.values())).shape[0]
    if "mrope_positions" in inputs:
        b = inputs["mrope_positions"].shape[1]
    jc, tc = both(pre, pre, init_cache(cfg, b, 32, SHD),
                  t_init_cache(tcfg, b, 32, device="cpu"))
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                             (b, steps)).astype(np.int32)
    for t in range(steps):
        one = {"tokens": toks[:, t:t + 1]}
        jc, tc = both(one, one, jc, tc)
    assert int(tc["index"]) == int(jc["index"]) == s_pre + steps
    return jc, tc


def decode_matches_full(name, b, s_pre, s_tot, seed, inputs=None, tol=2e-2):
    """tests/test_models.py's decode == full forward on the port: a
    prefill of `s_pre` tokens and greedy-free decode over the rest
    reproduce the full forward's logits (the reference's tolerance).
    Weights are the reference's init at `seed`, tokens drawn as there."""
    cfg, tcfg, _, tparams = zoo_model(name, "bfloat16", seed)
    key = jax.random.PRNGKey(seed)
    toks = to_torch(jax.random.randint(key, (b, s_tot), 0, cfg.vocab_size))
    extra = {k: to_torch(v) for k, v in (inputs or {}).items()}
    full, _, _ = t_forward(tparams, tcfg, tokens=toks, **extra)
    cache = t_init_cache(tcfg, b, 32, device="cpu")
    _, cache, _ = t_forward(tparams, tcfg, tokens=toks[:, :s_pre],
                            cache=cache, **extra)
    dec = []
    for t in range(s_pre, s_tot):
        lg, cache, _ = t_forward(tparams, tcfg, tokens=toks[:, t:t + 1],
                                 cache=cache)
        dec.append(lg[:, 0])
    got = torch.stack(dec, 1).float().numpy()
    np.testing.assert_allclose(got, full[:, s_pre:s_tot].float().numpy(),
                               rtol=tol, atol=tol)


def serve_both(name, slots=2, max_len=48):
    """tests/test_serve.py's 16-step schedule on the reference's fused
    engine and on the port's, f32, the same weights and prompts."""
    cfg, tcfg, params, tparams = zoo_model(name)
    ps = prompts(cfg, 8, 11)
    ref = run_16_steps(ServeEngine(cfg, params, batch_slots=slots,
                                   max_len=max_len, shd=SHD),
                       [jnp.asarray(p) for p in ps], Request)
    got = run_16_steps(TServeEngine(tcfg, tparams, batch_slots=slots,
                                    max_len=max_len, device="cpu"),
                       [torch.from_numpy(p) for p in ps], TRequest)
    return ref, got


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(flat(t, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: tree}


def check_init_cache(name, dtype):
    """The port's zero cache has the reference's paths, shapes, dtypes."""
    cfg = dataclasses.replace(REDUCED[name], dtype=dtype)
    tcfg = dataclasses.replace(T_REDUCED[name], dtype=dtype)
    want = flat(init_cache(cfg, 3, 40, SHD))
    got = flat(t_init_cache(tcfg, 3, 40, device="cpu"))
    assert sorted(got) == sorted(want)
    for path, a in want.items():
        t = got[path]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype) == f"torch.{a.dtype}", path
        assert not t.any()
    return got


def check_dispatch_raises(name):
    _, tcfg, _, tparams = zoo_model(name)
    with pytest.raises(ValueError, match="engine='dispatch'"):
        TServeEngine(tcfg, tparams, batch_slots=1, max_len=16,
                     device="cpu", engine="dispatch")


def check_launch_serve(name, capsys):
    assert t_launch.main(["--arch", name, "--reduced", "--device", "cpu",
                          "--requests", "3", "--max-new", "3"]) == 0
    assert "3 requests, 9 tokens" in capsys.readouterr().out


# --------------------------------------------------------------------- #
# the wkv routes and the RWKV sub-layers
# --------------------------------------------------------------------- #

def _wkv_inputs(b=2, s=24, h=4, hs=16, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, hs)).astype(np.float32)
               for _ in range(3))
    # decays in [e^-8, 1), the clamp's range, with both ends present
    w = np.exp(-np.minimum(np.exp(rng.normal(size=(b, s, h, hs)) * 2), 8.0))
    u = rng.normal(size=(h, hs)).astype(np.float32) * 0.1
    S0 = rng.normal(size=(b, h, hs, hs)).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, S0


def test_wkv_chunked_matches_reference():
    args = _wkv_inputs()
    S_j, o_j = JR._wkv_chunked(*map(jnp.asarray, args), JR.WKV_CHUNK)
    S_t, o_t = TR._wkv_chunked(*map(torch.from_numpy, args), TR.WKV_CHUNK)
    close(o_t, o_j)
    close(S_t, S_j)


def test_wkv_routes_agree():
    """The chunked form and the per-token recurrence (the decode step's)
    solve the same recurrence: held to each other and to an f64 loop."""
    args = _wkv_inputs(seed=1)
    S_c, o_c = TR._wkv_chunked(*map(torch.from_numpy, args), TR.WKV_CHUNK)
    S_p, o_p = TR._wkv_per_token(*map(torch.from_numpy, args))
    S_64, o_64 = TR._wkv_per_token(
        *(torch.from_numpy(a).double() for a in args))
    for got in (o_c, o_p):
        close(got, o_64.numpy())
    for got in (S_c, S_p):
        close(got, S_64.numpy())


@pytest.mark.parametrize("s", [1, 5, 16])
def test_time_and_channel_mix_match_reference(s):
    """`rwkv_time_mix` on both routes (s = 16: chunked; 1 and 5: per
    token) and `rwkv_channel_mix`, from a nonzero state."""
    cfg, tcfg, params, _ = zoo_model(NAME)
    rng = np.random.default_rng(s)
    p = jax.tree.map(lambda a: np.asarray(a[0]), params["layers"][0]["rwkv"])
    tp = bridge.params_from_numpy(p, device="cpu")
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    h, hs = cfg.n_rwkv_heads, cfg.rwkv_head_size
    state = {"wkv": rng.normal(size=(2, h, hs, hs)).astype(np.float32),
             "shift_tm": rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32),
             "shift_cm": rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)}
    js = {k: jnp.asarray(v) for k, v in state.items()}
    ts = {k: torch.from_numpy(v) for k, v in state.items()}
    jo, jst = JR.rwkv_time_mix(jnp.asarray(x), p, cfg, SHD, js)
    to, tst = TR.rwkv_time_mix(torch.from_numpy(x), tp, tcfg, ts)
    close(to, jo)
    for k in ("wkv", "shift_tm"):
        close(tst[k], jst[k])
    assert tst["wkv"].dtype == torch.float32
    jo, jst = JR.rwkv_channel_mix(jnp.asarray(x), p, cfg, SHD, js)
    to, tst = TR.rwkv_channel_mix(torch.from_numpy(x), tp, tcfg, ts)
    close(to, jo)
    close(tst["shift_cm"], jst["shift_cm"])


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("s_pre", [8, 11])
def test_forward_prefill_decode_match_reference(s_pre):
    """Prefill on the chunked route (8 tokens) and the per-token route
    (11), then decode steps; the full forward of 16 tokens is chunked."""
    toks = np.random.default_rng(s_pre).integers(
        0, REDUCED[NAME].vocab_size, (2, 16)).astype(np.int32)
    jc, tc = check_forward_prefill_decode(NAME, {"tokens": toks}, s_pre)
    for path, t in flat(tc["layers"]).items():
        close(t, flat(jc["layers"])[path])


def test_decode_matches_full_forward():
    """tests/test_models.py::test_decode_matches_full_forward[rwkv6-3b]."""
    decode_matches_full(NAME, 2, 8, 14, 11)


def test_rwkv_chunked_equals_per_token():
    """tests/test_models.py::test_rwkv_chunked_equals_per_token: the
    chunked full forward against prefill + per-token decode, f32."""
    cfg = dataclasses.replace(T_REDUCED[NAME], dtype="float32")
    _, _, _, tparams = zoo_model(NAME, "float32", 3)
    toks = to_torch(jax.random.randint(jax.random.PRNGKey(3), (2, 24), 0,
                                       cfg.vocab_size))
    full, _, _ = t_forward(tparams, cfg, tokens=toks)
    cache = t_init_cache(cfg, 2, 32, device="cpu")
    _, cache, _ = t_forward(tparams, cfg, tokens=toks[:, :8], cache=cache)
    dec = []
    for t in range(8, 24):
        lg, cache, _ = t_forward(tparams, cfg, tokens=toks[:, t:t + 1],
                                 cache=cache)
        dec.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(dec, 1).numpy(),
                               full[:, 8:24].numpy(), rtol=1e-4, atol=1e-4)


def test_serve_token_identical_to_reference():
    ref, got = serve_both(NAME)
    assert got == ref
    assert all(len(toks) == 3 + rid % 4 for rid, (toks, _) in got.items())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_cache_matches_reference(dtype):
    got = check_init_cache(NAME, dtype)
    assert got["layers.0.wkv"].dtype == torch.float32
    assert got["layers.0.shift_tm"].dtype == getattr(torch, dtype)


def test_dispatch_engine_raises():
    check_dispatch_raises(NAME)


def test_launch_serve_runs_on_cpu(capsys):
    check_launch_serve(NAME, capsys)
