"""The port's parameter tree has the reference's paths, shapes and dtypes,
and `bridge.params_from_numpy` moves the reference's weights bit for bit."""

import math

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, REDUCED
from repro.models import Shardings, init_params, param_defs
from repro_torch import bridge
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.models import init_params as t_init_params
from repro_torch.models import param_defs as t_param_defs

DENSE = ["granite-3-8b", "deepseek-coder-33b", "llama3-405b",
         "starcoder2-7b"]
MOE = ["mixtral-8x7b", "qwen2-moe-a2.7b"]
# mamba/attention hybrid, RWKV-6, encoder-decoder, M-RoPE
ZOO = ["jamba-1.5-large-398b", "rwkv6-3b", "whisper-tiny", "qwen2-vl-72b"]


def flat(tree, prefix=""):
    """{dotted path: leaf} of nested dicts/lists."""
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


def _def_table(defs, cfg):
    return {p: (tuple(d.shape), d.dtype or cfg.dtype, d.init)
            for p, d in flat(defs).items()}


@pytest.mark.parametrize("table", ["ARCHS", "REDUCED"])
@pytest.mark.parametrize("name", DENSE + MOE + ZOO)
def test_param_defs_match_reference(table, name):
    ref_cfg = (ARCHS if table == "ARCHS" else REDUCED)[name]
    cfg = (T_ARCHS if table == "ARCHS" else T_REDUCED)[name]
    assert _def_table(t_param_defs(cfg), cfg) == \
        _def_table(param_defs(ref_cfg), ref_cfg)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bridge_round_trips_bits(dtype):
    _round_trip("granite-3-8b", dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", MOE)
def test_bridge_round_trips_moe_bits(name, dtype):
    _round_trip(name, dtype)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", ZOO)
def test_bridge_round_trips_zoo_bits(name, dtype):
    """The new leaves (mamba, RWKV, the encoder subtree, cross-attention,
    qwen2-vl's biases) cross bit for bit."""
    _round_trip(name, dtype)


@pytest.mark.parametrize("table", ["ARCHS", "REDUCED"])
@pytest.mark.parametrize("name", MOE)
def test_moe_pattern_and_param_count_match_reference(table, name):
    """Every layer is MoE (period 1), `quant` is carried, and the counts
    that size the model agree with the reference's."""
    ref_cfg = (ARCHS if table == "ARCHS" else REDUCED)[name]
    cfg = (T_ARCHS if table == "ARCHS" else T_REDUCED)[name]
    assert [(s.kind, s.mlp, s.cross_attn) for s in cfg.layer_pattern()] == \
        [(s.kind, s.mlp, s.cross_attn) for s in ref_cfg.layer_pattern()] == \
        [("attn", "moe", False)]
    for active in (False, True):
        assert cfg.param_count(active) == ref_cfg.param_count(active)
    import dataclasses
    assert dataclasses.replace(cfg, quant="int8").quant == "int8"
    assert cfg.quant == ref_cfg.quant == ""


def _round_trip(name, dtype):
    import dataclasses
    ref_cfg = dataclasses.replace(REDUCED[name], dtype=dtype)
    params = init_params(jax.random.PRNGKey(0), ref_cfg, Shardings(None))
    arrays = jax.tree.map(np.asarray, params)
    tree = bridge.params_from_numpy(arrays, device="cpu")
    ref_flat, port_flat = flat(arrays), flat(tree)
    assert sorted(ref_flat) == sorted(port_flat)
    defs = flat(param_defs(ref_cfg))
    for path, arr in ref_flat.items():
        t = port_flat[path]
        assert tuple(t.shape) == arr.shape == defs[path].shape
        assert str(t.dtype) == f"torch.{defs[path].dtype or dtype}"
        if dtype == "bfloat16":
            got = t.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(got, arr.view(np.uint16))
        else:
            np.testing.assert_array_equal(t.numpy(), arr)


def test_init_params_tree_and_statistics():
    cfg = T_REDUCED["granite-3-8b"]
    tree = flat(t_init_params(0, cfg, device="cpu"))
    defs = flat(t_param_defs(cfg))
    assert sorted(tree) == sorted(defs)
    for path, t in tree.items():
        d = defs[path]
        assert tuple(t.shape) == d.shape and t.dtype == torch.bfloat16
        if d.init == "ones":
            assert bool((t == 1).all())
        elif d.init == "normal":
            # the reference's rule: fan_in = shape[-2] of the stacked tensor
            want = 1.0 / math.sqrt(d.shape[-2])
            assert abs(t.float().std().item() / want - 1) < 0.1, path
    again = flat(t_init_params(0, cfg, device="cpu"))
    assert all(torch.equal(tree[p], again[p]) for p in tree)
