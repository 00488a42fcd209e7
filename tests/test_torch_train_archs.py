"""The twin of tests/test_archs_smoke.py::test_train_step on the port: one
train step of every REDUCED arch (its own dtype, bf16 for most) on the
CPU, from the port's own weights and `make_batch`: a finite positive
loss, a finite gradient norm, the step counted, parameters changed
somewhere; and the training forward's remat groups and unbound leaves
giving the serving path's logits."""

import pytest
import torch

from repro_torch.configs import REDUCED
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.models import forward, init_params
from repro_torch.train import (DataConfig, HParams, adamw_init, make_batch,
                               make_eval_step, make_train_step)
from repro_torch.train.optimizer import leaves

B, S = 2, 16


@pytest.mark.parametrize("name", sorted(REDUCED))
def test_train_step(name):
    cfg = REDUCED[name]
    params = init_params(0, cfg, device="cpu")
    before = [t.clone() for t in leaves(params)]
    opt = adamw_init(params, cfg)
    step = make_train_step(cfg, HParams(warmup_steps=2, total_steps=10))
    batch = make_batch(cfg, ShapeConfig("t", S, B, "train"), 0, DataConfig(),
                       "cpu")
    p2, o2, m = step(params, opt, batch)
    assert torch.isfinite(m["loss"]) and float(m["loss"]) > 0
    assert torch.isfinite(m["grad_norm"])
    assert int(o2["step"]) == 1
    assert any(not torch.equal(a, b) for a, b in zip(before, leaves(p2)))
    eval_loss = make_eval_step(cfg)(p2, batch)
    assert eval_loss.grad_fn is None and torch.isfinite(eval_loss)


@pytest.mark.parametrize("name", ["granite-3-8b", "whisper-tiny"])
def test_training_forward_equals_the_plain_forward(name):
    """With grad enabled and no cache the blocks run in checkpointed remat
    groups over unbound leaves; the logits are the no-grad forward's."""
    import dataclasses
    cfg = dataclasses.replace(REDUCED[name], dtype="float32", remat_group=2,
                              n_layers=4)
    params = init_params(0, cfg, device="cpu")
    batch = make_batch(cfg, ShapeConfig("t", S, B, "train"), 0, DataConfig(),
                       "cpu")
    kw = {k: v for k, v in batch.items() if k != "labels"}
    for t in leaves(params):
        t.requires_grad_(True)
    train_logits = forward(params, cfg, **kw)[0]
    assert train_logits.grad_fn is not None
    with torch.no_grad():
        plain = forward(params, cfg, **kw)[0]
    assert torch.equal(train_logits.detach(), plain)
