"""`repro_torch.models.cache` equals the reference exactly: slot
positions, decode writes (scalar and per-row index) and prefill writes,
full and ring caches, across the ring wrap."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cache as JC
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.models import cache as TC

B, KVH, HD = 3, 2, 4


@pytest.mark.parametrize("width", [8, 32])
@pytest.mark.parametrize("count", [0, 1, 7, 8, 9, 23, 64])
def test_slot_positions_scalar(count, width):
    np.testing.assert_array_equal(
        TC.slot_positions(count, width).numpy(),
        np.asarray(JC.slot_positions(count, width)))


@pytest.mark.parametrize("width", [8, 32])
def test_slot_positions_per_row(width):
    counts = np.array([0, 1, 5, 8, 9, 31, 40], np.int32)
    np.testing.assert_array_equal(
        TC.slot_positions(torch.from_numpy(counts), width).numpy(),
        np.asarray(JC.slot_positions(jnp.asarray(counts), width)))


def _kv(rng, width):
    k = rng.normal(size=(B, width, KVH, HD)).astype(np.float32)
    v = rng.normal(size=(B, width, KVH, HD)).astype(np.float32)
    return k, v


def _both(k, v):
    return ({"k": jnp.asarray(k), "v": jnp.asarray(v)},
            {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())})


def _equal(jkv, tkv):
    for name in ("k", "v"):
        np.testing.assert_array_equal(tkv[name].numpy(),
                                      np.asarray(jkv[name]))


@pytest.mark.parametrize("index", [0, 5, 8, 13])
def test_write_decode_scalar(index):
    rng = np.random.default_rng(index)
    width = 8
    jkv, tkv = _both(*_kv(rng, width))
    kn, vn = _kv(rng, 1)
    want = JC.write_decode(jkv, jnp.asarray(kn), jnp.asarray(vn), index,
                           width)
    got = TC.write_decode(tkv, torch.from_numpy(kn), torch.from_numpy(vn),
                          index, width)
    _equal(want, got)
    _equal(want, tkv)                     # written in place


@pytest.mark.parametrize("width", [8, 32])
def test_write_decode_per_row(width):
    rng = np.random.default_rng(width)
    jkv, tkv = _both(*_kv(rng, width))
    kn, vn = _kv(rng, 1)
    index = np.array([3, 8, 29], np.int32)      # 8 and 29 wrap a ring of 8
    want = JC.write_decode(jkv, jnp.asarray(kn), jnp.asarray(vn),
                           jnp.asarray(index), width)
    got = TC.write_decode(tkv, torch.from_numpy(kn), torch.from_numpy(vn),
                          torch.from_numpy(index), width)
    _equal(want, got)


@pytest.mark.parametrize("s", [1, 5, 8, 13, 21])
def test_write_prefill(s):
    rng = np.random.default_rng(s)
    width = 8                                   # s > 8 rolls the ring
    jkv, tkv = _both(*_kv(rng, width))
    kf = rng.normal(size=(B, s, KVH, HD)).astype(np.float32)
    vf = rng.normal(size=(B, s, KVH, HD)).astype(np.float32)
    want = JC.write_prefill(jkv, jnp.asarray(kf), jnp.asarray(vf))
    got = TC.write_prefill(tkv, torch.from_numpy(kf), torch.from_numpy(vf))
    _equal(want, got)


def test_cache_width_and_init():
    from repro.configs import REDUCED
    from repro.models import init_cache
    for name in ("granite-3-8b", "starcoder2-7b"):
        cfg, tcfg = REDUCED[name], T_REDUCED[name]
        for max_len in (8, 16, 64):
            assert TC.cache_width(tcfg, max_len) == \
                JC.cache_width(cfg, max_len)
        ref = init_cache(cfg, 2, 64)
        got = TC.init_cache(tcfg, 2, 64, device="cpu")
        assert got["index"].dtype == torch.int32 and int(got["index"]) == 0
        for r, g in zip(ref["layers"], got["layers"]):
            for name_ in ("k", "v"):
                assert tuple(g[name_].shape) == r[name_].shape
                assert str(g[name_].dtype) == f"torch.{r[name_].dtype}"
                assert not g[name_].any()
