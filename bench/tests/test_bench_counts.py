"""The work counts against numbers worked by hand, and the benchmark's
weight layout against the program's parameter tree."""

import json
import math

import pytest

from bench import counts, weights
from bench.tests.tiny import DENSE, MOE, ROOT


def _cfg(name):
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


GRANITE, QWEN = _cfg("granite-3-8b"), _cfg("qwen2-moe-a2.7b")


def test_kv_bytes_per_token():
    # 40 layers x (K and V) x 8 heads x 128 x 2 bytes; 24 x 2 x 16 x 128 x 2
    assert counts.Counts(GRANITE).kv_bytes_per_token() == 163_840
    assert counts.Counts(QWEN).kv_bytes_per_token() == 196_608


def test_flash_counts():
    c = counts.Counts(GRANITE)
    assert c.flash_flops(1024) == 2 * 1024**2 * 128 * 32
    # Q and O: 32 heads, K and V: 8 heads, 128 wide, 2 bytes
    assert c.flash_bytes(1024) == 1024 * (2 * 32 + 2 * 8) * 128 * 2


def test_decode_attention_counts_live_lengths():
    c = counts.Counts(GRANITE)
    assert c.decode_attn_flops([10, 20]) == 4 * 30 * 32 * 128
    assert c.decode_attn_bytes([10, 20]) == (30 * 2 * 8 * 128
                                             + 2 * 2 * 32 * 128) * 2


def test_weight_bytes():
    # qwen's vocabulary needs no padding: the program's 28,631,568,384 B
    assert counts.Counts(QWEN).weight_bytes() == 28_631_568_384
    lay = weights.layout(GRANITE)
    total = sum(math.prod(shape) for _, shape, _, _ in lay) * 2
    pad = (49280 - 49155) * 4096 * 2          # one tied matrix
    assert counts.Counts(GRANITE).weight_bytes() == total - pad
    assert total == 16_342_720_512


def test_prefill_and_decode_flops_by_hand():
    c = counts.Counts(DENSE)
    d, h, kvh, hd, f, v, L = 64, 4, 2, 16, 160, 515, 2
    layer = 2 * d * h * hd + 2 * d * kvh * hd + 3 * d * f
    n = 10
    assert c.prefill_flops(n) == (2 * n * L * layer + L * 2 * n * n * hd * h
                                  + 2 * d * v)
    lengths = [5, 9, 12]
    assert c.decode_flops(lengths) == (2 * 3 * (L * layer + d * v)
                                       + L * 4 * sum(lengths) * h * hd)


def test_moe_counts_route_top_k():
    c = counts.Counts(QWEN)
    d, e, k, fe, fs = 2048, 60, 4, 1408, 5632
    assert c.layer_active == (2 * d * 16 * 128 * 2 + d * e + 3 * d * fs + d
                              + k * 3 * d * fe)
    assert c.experts_touched(1) == pytest.approx(4.0)
    assert c.experts_touched(64) == pytest.approx(60 * (1 - (56 / 60)**64))
    assert counts.Counts(GRANITE).experts_touched(64) == 0.0


@pytest.mark.parametrize("c", [GRANITE, QWEN, DENSE, MOE],
                         ids=["granite", "qwen", "dense", "moe"])
def test_layout_is_the_programs_parameter_tree(c):
    from repro_torch.models import param_defs
    from repro_torch.models.sharding import tree_map

    from bench.model import model_config
    want = {}

    def note(path, d):
        want[path] = d.shape

    def walk(tree, path):
        if isinstance(tree, dict):
            for key, sub in tree.items():
                walk(sub, path + (key,))
        elif isinstance(tree, list):
            for i, sub in enumerate(tree):
                walk(sub, path + (i,))
        else:
            note(path, tree)

    walk(tree_map(lambda d: d, param_defs(model_config(c))), ())
    got = {path: shape for path, shape, _, _ in weights.layout(c)}
    assert got == want
