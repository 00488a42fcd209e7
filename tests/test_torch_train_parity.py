"""The port's training step against the reference's at f32, for every
REDUCED arch, on the reference's weights (bridged) and the reference's
`make_batch` (as numpy, so both sides see the same batch).

Bands: `lm_loss` and `loss_fn` within 1e-5 relative; every gradient leaf
within 1e-4 of its own max |g| — or, where the reference's own f32
gradient is further than that from an f64 run of the port (whisper-tiny:
measured 3.3e-4 for the reference, 1.0e-4 for the port, whose layer norms
and attention sum in another order), no further from that f64 run than
the reference's is. Then both packages' `adamw_update` take the same
gradients (the reference's) three times from the same state: params, m
and v within ADAMW_TOL (1e-5) of each leaf's scale (measured at most
2.6e-6, whisper-tiny's v; the learning rate differs by an ulp, f32 cos of
two libraries). Three whole train steps are not compared: where a true
gradient is zero or nearly so (a key bias, whose gradient softmax makes
exactly zero), m / sqrt(v) is the sign of f32 rounding noise in either
package, so the trajectories part by up to 2 lr on such entries. The
reference's step is jitted. The archs are split
over this file and tests/test_torch_train_parity_b.py; the helpers here
serve those and tests/test_torch_train_parity_{adamw,accum}.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REDUCED
from repro.configs.shapes import ShapeConfig as JShape
from repro.models import Shardings, forward, init_params
from repro.models import lm_loss as j_lm_loss
from repro.train import DataConfig, loss_fn as j_loss_fn
from repro.train import HParams as JHParams, adamw_init as j_adamw_init
from repro.train import adamw_update as j_adamw_update
from repro.train import make_batch as j_make_batch
from repro_torch import bridge
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.kernels import ops, ref
from repro_torch.models import forward as t_forward, lm_loss
from repro_torch.train import HParams, adamw_init, adamw_update, loss_fn
from repro_torch.train.optimizer import leaves
from repro_torch.train.step import value_and_grad

SHD = Shardings(None)
NAMES = sorted(REDUCED)
# the archs of this file; the rest run in test_torch_train_parity_b.py
HERE = NAMES[:5]
SHAPE = JShape("t", 16, 2, "train")
GRAD_TOL = 1e-4
ADAMW_TOL = 1e-5
HP = dict(lr=1e-3, warmup_steps=2, total_steps=10)


@functools.cache
def model(name, seed=0):
    """(cfg, tcfg, params, batch): REDUCED `name` at f32 in both packages,
    the reference's weights and step-0 batch (jax arrays)."""
    cfg = dataclasses.replace(REDUCED[name], dtype="float32")
    tcfg = dataclasses.replace(T_REDUCED[name], dtype="float32")
    params = init_params(jax.random.PRNGKey(seed), cfg, SHD)
    batch = j_make_batch(cfg, SHAPE, 0, DataConfig())
    return cfg, tcfg, params, batch


def to_port(tree, dtype=None):
    """A jax tree -> the same tree of CPU tensors (bits kept; `dtype`
    casts floating leaves)."""
    if dtype is not None:
        tree = jax.tree.map(lambda x: np.asarray(x, dtype)
                            if np.asarray(x).dtype.kind == "f" else x, tree)
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree),
                                    device="cpu")


def rel_errs(got_tree, want_tree) -> list:
    """Per leaf: max |got - want| / max |want|."""
    out = []
    for g, w in zip(leaves(got_tree), jax.tree.leaves(want_tree)):
        w = np.asarray(w, np.float64)
        err = np.abs(g.double().numpy() - w).max()
        out.append(float(err / max(np.abs(w).max(), 1e-30)))
    return out


@functools.cache
def f64_grads(name):
    """The port's gradients in f64 on the same weights and batch, its
    attention on the plain version under autograd (the wrappers take f32
    and bf16 only)."""
    cfg, tcfg, params, batch = model(name)
    t64 = dataclasses.replace(tcfg, dtype="float64")
    saved = ops.flash_attention
    ops.flash_attention = ref.flash_attention
    try:
        _, g = value_and_grad(to_port(params, np.float64),
                              to_port(batch, np.float64), t64)
    finally:
        ops.flash_attention = saved
    return g


def assert_grads_close(name, got, want, tol=GRAD_TOL):
    """Every leaf within `tol` of its own scale, or no further from the
    f64 run than the reference's leaf is."""
    errs = rel_errs(got, want)
    if max(errs) <= tol:
        return
    truth = leaves(f64_grads(name))
    for i, (e, g, w, t) in enumerate(zip(errs, leaves(got),
                                         jax.tree.leaves(want), truth)):
        if e <= tol:
            continue
        t = t.numpy()
        scale = np.abs(t).max()
        port = np.abs(g.double().numpy() - t).max() / scale
        ref = np.abs(np.asarray(w, np.float64) - t).max() / scale
        assert port <= ref, (i, e, port, ref)


@functools.cache
def ref_value_and_grad(name):
    cfg, _, params, batch = model(name)
    return jax.jit(jax.value_and_grad(
        lambda p, b: j_loss_fn(p, b, cfg, SHD)))(params, batch)


def check_loss_and_gradients(name):
    cfg, tcfg, params, batch = model(name)
    want_loss, want = ref_value_and_grad(name)
    tparams, tbatch = to_port(params), to_port(batch)
    got_loss, got = value_and_grad(tparams, tbatch, tcfg)
    assert float(got_loss) == pytest.approx(float(want_loss), rel=1e-5)
    assert float(loss_fn(tparams, tbatch, tcfg)) == pytest.approx(
        float(want_loss), rel=1e-5)
    for g, p in zip(leaves(got), leaves(tparams)):
        assert g.dtype == p.dtype and g.shape == p.shape
    assert_grads_close(name, got, want)
    # lm_loss alone, both packages on the port's logits and aux
    with torch.no_grad():
        logits, _, aux = t_forward(tparams, tcfg, **{
            k: v for k, v in tbatch.items() if k != "labels"})
    want_lm = j_lm_loss(jnp.asarray(logits.numpy()), batch["labels"],
                        jnp.asarray(aux.numpy()), cfg.router_aux_loss)
    assert float(lm_loss(logits, tbatch["labels"], aux,
                         tcfg.router_aux_loss)) == pytest.approx(
        float(want_lm), rel=1e-5)


def check_adamw(name):
    cfg, tcfg, params, _ = model(name)
    _, grads = ref_value_and_grad(name)
    upd = jax.jit(lambda p, g, o: j_adamw_update(p, g, o, JHParams(**HP),
                                                 cfg))
    jp, jo = params, j_adamw_init(params, cfg)
    tp, tg = to_port(params), to_port(grads)
    to = adamw_init(tp, tcfg)
    for _ in range(3):
        jp, jo, jm = upd(jp, grads, jo)
        tp, to, tm = adamw_update(tp, tg, to, HParams(**HP), tcfg)
    assert int(to["step"]) == int(jo["step"]) == 3
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                   rel=1e-5)
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    for got, want in ((tp, jp), (to["m"], jo["m"]), (to["v"], jo["v"])):
        assert max(rel_errs(got, want)) <= ADAMW_TOL


@pytest.mark.parametrize("name", HERE)
def test_loss_and_gradients_match_reference(name):
    check_loss_and_gradients(name)


@pytest.mark.parametrize("name", HERE)
def test_three_adamw_updates_match_reference(name):
    check_adamw(name)


@pytest.mark.parametrize("name", ["granite-3-8b", "qwen2-moe-a2.7b"])
def test_lm_loss_matches_reference(name):
    """lm_loss on the same logits (the padded vocab masked) and labels,
    with the MoE aux loss where there is one."""
    cfg, tcfg, params, batch = model(name)
    kw = {k: v for k, v in batch.items() if k != "labels"}
    logits, _, aux = jax.jit(lambda p, kw: forward(p, cfg, SHD, **kw))(
        params, kw)
    want = j_lm_loss(logits, batch["labels"], aux, cfg.router_aux_loss)
    got = lm_loss(torch.from_numpy(np.array(logits)),
                  torch.from_numpy(np.array(batch["labels"])),
                  torch.tensor(float(aux)), tcfg.router_aux_loss)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    tl, _, taux = t_forward(to_port(params), tcfg,
                            **{k: v for k, v in to_port(batch).items()
                               if k != "labels"})
    assert float(taux) == pytest.approx(float(aux), rel=1e-5, abs=1e-7)
