"""Mamba and the jamba hybrid in the port against `repro`, on REDUCED
jamba-1.5-large-398b (one block of 8 layers: mamba, attention at position
4, MoE every other layer) with the reference's weights, inputs drawn with
numpy from a seed.

Tolerances as in tests/test_torch_zoo_rwkv.py: f32 within 1e-4 of the
scale, tests/test_models.py's twin at its 2e-2, serving token identity
at f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED
from repro.models import layers as JL
from repro.models import mamba as JM
from repro_torch import bridge
from repro_torch.models import layers as TL
from repro_torch.models import mamba as TM
from test_torch_zoo_rwkv import (SHD, check_dispatch_raises,
                                 check_forward_prefill_decode,
                                 check_init_cache, check_launch_serve, close,
                                 decode_matches_full, flat, serve_both,
                                 zoo_model)

NAME = "jamba-1.5-large-398b"


def _mamba_layer():
    cfg, tcfg, params, _ = zoo_model(NAME)
    assert cfg.layer_pattern()[0].kind == "mamba"
    p = jax.tree.map(lambda a: np.asarray(a[0]), params["layers"][0]["mamba"])
    # conv bias and dt bias start at 0: move them off it
    rng = np.random.default_rng(5)
    for k in ("conv_b", "dt_bias"):
        p[k] = (p[k] + rng.normal(size=p[k].shape) * 0.1).astype(np.float32)
    return cfg, tcfg, p, bridge.params_from_numpy(p, device="cpu")


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 7])
def test_causal_conv_matches_reference(s, with_state):
    rng = np.random.default_rng(s)
    k, di = 4, 12
    x = rng.normal(size=(2, s, di)).astype(np.float32)
    w = rng.normal(size=(k, di)).astype(np.float32)
    b = rng.normal(size=(di,)).astype(np.float32)
    st = (rng.normal(size=(2, k - 1, di)).astype(np.float32)
          if with_state else None)
    jo, js = JM._causal_conv(*map(jnp.asarray, (x, w, b)),
                             None if st is None else jnp.asarray(st))
    to, ts = TM._causal_conv(*map(torch.from_numpy, (x, w, b)),
                             None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("s,chunk", [(24, 8), (64, 16), (5, 8)])
def test_ssm_scan_chunked_matches_reference(s, chunk):
    """The scan on its own; s = 5 < chunk takes a whole chunk of 5 (as
    `mamba_forward` calls it with min(chunk, s))."""
    chunk = min(chunk, s)
    rng = np.random.default_rng(s)
    b, di, ds = 2, 6, 4
    # dA spans (0, 1]: some steps forget almost everything
    dA = np.exp(-np.abs(rng.normal(size=(b, s, di, ds))) * 3)
    dBx = rng.normal(size=(b, s, di, ds))
    C = rng.normal(size=(b, s, ds))
    h0 = rng.normal(size=(b, di, ds))
    args = [a.astype(np.float32) for a in (dA, dBx, C, h0)]
    jy, jh = JM._ssm_scan_chunked(*map(jnp.asarray, args), chunk)
    ty, th = TM._ssm_scan_chunked(*map(torch.from_numpy, args), chunk)
    close(ty, jy)
    close(th, jh)
    # and against an f64 step-by-step recurrence
    h, ys = torch.from_numpy(h0), []
    for t in range(s):
        h = torch.from_numpy(dA[:, t]) * h + torch.from_numpy(dBx[:, t])
        ys.append(torch.einsum("bds,bs->bd", h, torch.from_numpy(C[:, t])))
    close(ty, torch.stack(ys, 1).numpy())


@pytest.mark.parametrize("s", [1, 13, 16])
def test_mamba_forward_matches_reference(s):
    """Training form (no state) and prefill from a nonzero state: s = 13
    pads its last chunk of 8 with identity steps; s = 1 with a state is a
    decode step."""
    cfg, tcfg, p, tp = _mamba_layer()
    rng = np.random.default_rng(s)
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    jo, _ = JM.mamba_forward(jnp.asarray(x), p, cfg, SHD, None)
    to, _ = TM.mamba_forward(torch.from_numpy(x), tp, tcfg, None)
    close(to, jo)
    st = {"h": rng.normal(size=(2, cfg.d_inner, cfg.ssm_d_state)),
          "conv": rng.normal(size=(2, cfg.ssm_d_conv - 1, cfg.d_inner))}
    st = {k: v.astype(np.float32) for k, v in st.items()}
    jo, js = JM.mamba_forward(jnp.asarray(x), p, cfg, SHD,
                              {k: jnp.asarray(v) for k, v in st.items()})
    to, ts = TM.mamba_forward(torch.from_numpy(x), tp, tcfg,
                              {k: torch.from_numpy(v) for k, v in st.items()})
    close(to, jo)
    for k in ("h", "conv"):
        close(ts[k], js[k])
    assert ts["h"].dtype == torch.float32


@pytest.mark.parametrize("s_pre", [8, 13])
def test_forward_prefill_decode_match_reference(s_pre):
    toks = np.random.default_rng(s_pre).integers(
        0, REDUCED[NAME].vocab_size, (2, 16)).astype(np.int32)
    jc, tc = check_forward_prefill_decode(NAME, {"tokens": toks}, s_pre)
    want = flat(jc["layers"])
    for path, t in flat(tc["layers"]).items():
        close(t, want[path])


def test_decode_matches_full_forward_jamba(monkeypatch):
    """tests/test_models.py::test_decode_matches_full_forward_jamba, its
    non-binding capacity (8.0) set in both packages."""
    monkeypatch.setattr(JL, "CAPACITY_FACTOR", 8.0)
    monkeypatch.setattr(TL, "CAPACITY_FACTOR", 8.0)
    decode_matches_full(NAME, 2, 8, 12, 12)


def test_serve_token_identical_to_reference():
    ref, got = serve_both(NAME)
    assert got == ref
    assert all(len(toks) == 3 + rid % 4 for rid, (toks, _) in got.items())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_cache_matches_reference(dtype):
    got = check_init_cache(NAME, dtype)
    assert got["layers.0.h"].dtype == torch.float32
    assert got["layers.0.conv"].dtype == getattr(torch, dtype)
    assert sorted(k for k in got if k.startswith("layers.4.")) == \
        ["layers.4.k", "layers.4.v"]


def test_dispatch_engine_raises():
    check_dispatch_raises(NAME)


def test_launch_serve_runs_on_cpu(capsys):
    check_launch_serve(NAME, capsys)
