"""Dense building blocks of `repro_torch.models.layers` against the
reference's, on the same weights (bridged) and inputs (numpy seed).

Tolerances: f32 agrees to 1e-5 (order of sums only); bf16 to 3e-2 of the
output's scale (one bf16 rounding step, 2^-8, at a few places that the two
frameworks round differently)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED
from repro.models import Shardings, init_params
from repro.models import layers as JL
from repro_torch import bridge
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.models import layers as TL

SHD = Shardings(None)
TOL = {"float32": 1e-5, "bfloat16": 3e-2}
# granite: RMS norm, gated silu MLP; starcoder2: layer norm, qkv bias,
# non-gated gelu MLP
ARCHS = ["granite-3-8b", "starcoder2-7b"]


def _setup(name, dtype):
    ref_cfg = dataclasses.replace(REDUCED[name], dtype=dtype)
    cfg = dataclasses.replace(T_REDUCED[name], dtype=dtype)
    params = init_params(jax.random.PRNGKey(1), ref_cfg, SHD)
    rng = np.random.default_rng(3)
    jp = jax.tree.map(lambda a: np.asarray(a[0]), params["layers"][0])

    def jitter(a):   # biases and norm scales, which the init sets to 0 / 1
        if a.ndim == 1 or (a.ndim == 2 and a.shape[0] < cfg.d_model):
            noise = rng.normal(size=a.shape).astype(np.float32) * 0.1
            return (a + noise).astype(a.dtype)
        return a
    jp = jax.tree.map(jitter, jp)
    tp = bridge.params_from_numpy(jp, device="cpu")
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    xt = bridge.tensor_from_numpy(np.asarray(xj), "cpu")
    return ref_cfg, cfg, jp, tp, xj, xt


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL[dtype] * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_apply_norm(name, dtype):
    ref_cfg, cfg, jp, tp, xj, xt = _setup(name, dtype)
    _close(TL.apply_norm(xt, tp["ln1"], cfg),
           JL.apply_norm(xj, jp["ln1"], ref_cfg), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope(dtype):
    ref_cfg, cfg, _, _, xj, xt = _setup("granite-3-8b", dtype)
    pos = np.array([[0, 1, 2, 3, 4], [7, 9, 11, 40, 41]], np.int32)
    sj, cj = JL.rope_sincos(jnp.asarray(pos), ref_cfg)
    st, ct = TL.rope_sincos(torch.from_numpy(pos), cfg)
    _close(st, sj, "float32")
    _close(ct, cj, "float32")
    h = cfg.n_heads
    q = np.random.default_rng(4).normal(size=(2, 5, h, cfg.hd))
    qj = jnp.asarray(q, dtype)
    qt = bridge.tensor_from_numpy(np.asarray(qj), "cpu")
    _close(TL.apply_rope(qt, st, ct), JL.apply_rope(qj, sj, cj), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_qkv_and_attn_out(name, dtype):
    ref_cfg, cfg, jp, tp, xj, xt = _setup(name, dtype)
    pos = np.arange(5, dtype=np.int32)[None].repeat(2, 0)
    sj, cj = JL.rope_sincos(jnp.asarray(pos), ref_cfg)
    st, ct = TL.rope_sincos(torch.from_numpy(pos), cfg)
    got = TL._qkv(xt, tp["attn"], cfg, rope_sin=st, rope_cos=ct)
    want = JL._qkv(xj, jp["attn"], ref_cfg, SHD, rope_sin=sj, rope_cos=cj)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w, dtype)
    o = np.random.default_rng(5).normal(size=(2, 5, cfg.n_heads, cfg.hd))
    oj = jnp.asarray(o, dtype)
    ot = bridge.tensor_from_numpy(np.asarray(oj), "cpu")
    _close(TL.attn_out(ot, tp["attn"], ot.dtype),
           JL.attn_out(oj, jp["attn"], oj.dtype, SHD), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCHS)
def test_mlp_forward(name, dtype):
    ref_cfg, cfg, jp, tp, xj, xt = _setup(name, dtype)
    _close(TL.mlp_forward(xt, tp["mlp"], cfg),
           JL.mlp_forward(xj, jp["mlp"], ref_cfg, SHD), dtype)
