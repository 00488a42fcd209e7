"""qwen2-vl's M-RoPE and `embeds` input in the port against `repro`, on
REDUCED qwen2-vl-72b with the reference's weights, inputs drawn with
numpy from a seed; the M-RoPE sections also at the full config's head dim
(128: sections of 21, 21 and 22 frequencies).

Tolerances as in tests/test_torch_zoo_rwkv.py: f32 within 1e-4 of the
scale, tests/test_models.py's twin at its 1e-6, serving token identity
at f32."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, REDUCED
from repro.models import layers as JL
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.models import layers as TL
from test_torch_zoo_rwkv import (check_dispatch_raises,
                                 check_forward_prefill_decode,
                                 check_init_cache, check_launch_serve, close,
                                 serve_both)

NAME = "qwen2-vl-72b"


def _grid_positions(b, s, seed):
    """(3, B, S) streams that differ: a text prefix, then a visual grid
    (t fixed, h and w walking the rows and columns), then text again."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((3, b, s), np.int32)
    for i in range(b):
        start = int(rng.integers(0, 5))
        n_text = 3
        pos[:, i, :n_text] = start + np.arange(n_text)
        g = s - 2 * n_text
        side = int(np.ceil(np.sqrt(g)))
        t0 = start + n_text
        pos[0, i, n_text:n_text + g] = t0
        pos[1, i, n_text:n_text + g] = t0 + np.arange(g) // side
        pos[2, i, n_text:n_text + g] = t0 + np.arange(g) % side
        nxt = pos[:, i, n_text + g - 1].max() + 1
        pos[:, i, n_text + g:] = nxt + np.arange(s - n_text - g)
    assert not (pos[0] == pos[1]).all()
    return pos


@pytest.mark.parametrize("table", ["ARCHS", "REDUCED"])
def test_mrope_sections_match_reference(table):
    cfg = (ARCHS if table == "ARCHS" else REDUCED)[NAME]
    tcfg = (T_ARCHS if table == "ARCHS" else T_REDUCED)[NAME]
    pos = _grid_positions(2, 40, 0) * 37           # large angles too
    sj, cj = JL.rope_sincos(jnp.asarray(pos), cfg)
    st, ct = TL.rope_sincos(torch.from_numpy(pos), tcfg)
    assert tuple(st.shape) == sj.shape == (2, 40, cfg.hd // 2)
    close(st, sj, 1e-5)
    close(ct, cj, 1e-5)
    # each section follows its own stream
    hd2 = cfg.hd // 2
    s1, s2 = hd2 // 3, 2 * (hd2 // 3)
    freqs = TL.rope_freqs(tcfg)
    for lo, hi, stream in ((0, s1, 0), (s1, s2, 1), (s2, hd2, 2)):
        angle = torch.from_numpy(pos[stream]).float()[..., None] \
            * freqs[lo:hi]
        close(st[..., lo:hi], torch.sin(angle.double()).numpy(), 1e-5)


def test_mrope_reduces_to_rope_for_text():
    """tests/test_models.py::test_mrope_reduces_to_rope_for_text."""
    cfg = T_REDUCED[NAME]
    b, s = 2, 8
    pos = torch.arange(s)[None].repeat(b, 1)
    sin_m, cos_m = TL.rope_sincos(pos[None].expand(3, b, s), cfg)
    sin_1, cos_1 = TL.rope_sincos(pos, dataclasses.replace(cfg, rope="rope"))
    np.testing.assert_allclose(sin_m.numpy(), sin_1.numpy(), rtol=1e-6)
    np.testing.assert_allclose(cos_m.numpy(), cos_1.numpy(), rtol=1e-6)


def test_forward_prefill_decode_with_tokens():
    toks = np.random.default_rng(1).integers(
        0, REDUCED[NAME].vocab_size, (2, 16)).astype(np.int32)
    check_forward_prefill_decode(NAME, {"tokens": toks}, 10)


@pytest.mark.parametrize("s_pre", [9, 16])
def test_forward_prefill_decode_with_embeds_and_grid(s_pre):
    """`embeds` input with distinct (3, B, S) position streams; decode
    steps then take the default positions (all three streams equal)."""
    cfg = REDUCED[NAME]
    rng = np.random.default_rng(s_pre)
    embeds = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    check_forward_prefill_decode(
        NAME, {"embeds": embeds,
               "mrope_positions": _grid_positions(2, 16, s_pre)}, s_pre)


def test_serve_token_identical_to_reference():
    ref, got = serve_both(NAME)
    assert got == ref
    assert all(len(toks) == 3 + rid % 4 for rid, (toks, _) in got.items())


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_cache_matches_reference(dtype):
    check_init_cache(NAME, dtype)


def test_dispatch_engine_raises():
    """The port refuses M-RoPE on the planner-routed path: its steps carry
    (B, S) positions, not the three streams."""
    check_dispatch_raises(NAME)


def test_launch_serve_runs_on_cpu(capsys):
    check_launch_serve(NAME, capsys)
