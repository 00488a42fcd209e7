"""Gradient accumulation (`accum_steps=2`) in the port's train step
against the reference's, for the REDUCED archs, checked as
tests/test_torch_train_parity.py checks one step: the loss within 1e-5
relative, the global norm within 1e-4, and the accumulated gradients
within 1e-4 of each leaf's scale (or no further from the f64 run than the
reference's). The gradients are read back from m after the step (m = (1 -
b1) x the clipped gradients, divided again by the clip scale of each
side's own norm). qwen2-vl-72b is left out: the reference splits every
batch field along axis 0, and its (3, B, S) M-RoPE positions cannot be
cut so (the port cuts them along the batch axis)."""

import jax
import pytest
import torch

from repro.train import HParams as JHParams, adamw_init as j_adamw_init
from repro.train import make_train_step as j_make_train_step
from repro_torch.models.sharding import tree_map
from repro_torch.train import HParams, adamw_init, make_train_step
from test_torch_train_parity import (HP, NAMES, SHD, assert_grads_close,
                                     model, to_port)

ACCUM = 2
ARCHS = [n for n in NAMES if n != "qwen2-vl-72b"]


def _grads_from_m(m, gnorm, hp):
    scale = min(1.0, hp.clip_norm / max(float(gnorm), 1e-9))
    return m / ((1 - hp.b1) * scale)


@pytest.mark.parametrize("name", ARCHS)
def test_accumulated_step_matches_reference(name):
    cfg, tcfg, params, batch = model(name)
    step = jax.jit(j_make_train_step(cfg, SHD, JHParams(**HP), ACCUM))
    _, jo, jm = step(params, j_adamw_init(params, cfg), batch)
    tp = to_port(params)
    _, to, tm = make_train_step(tcfg, HParams(**HP), ACCUM)(
        tp, adamw_init(tp, tcfg), to_port(batch))
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-4)
    hp = HParams(**HP)
    got = tree_map(lambda m: _grads_from_m(m, tm["grad_norm"], hp), to["m"],
                   is_leaf=torch.is_tensor)
    want = jax.tree.map(lambda m: _grads_from_m(m, jm["grad_norm"], hp),
                        jo["m"])
    assert_grads_close(name, got, want)


def test_micro_batches_cut_mrope_positions_along_the_batch():
    """qwen2-vl: the port's micro-batches cut the (3, B, S) M-RoPE
    positions along their batch axis and the other fields along axis 0."""
    from repro_torch.train.step import _micro
    _, tcfg, _, batch = model("qwen2-vl-72b")
    tb = to_port(batch)
    halves = [_micro(tb, ACCUM, i) for i in range(ACCUM)]
    assert halves[0]["mrope_positions"].shape[1] == \
        tb["mrope_positions"].shape[1] // ACCUM
    assert torch.equal(torch.cat([h["embeds"] for h in halves]), tb["embeds"])
