"""Train and eval steps, the counterpart of `repro.train.step`.

`make_train_step(cfg, hp, accum_steps)` returns `train_step(params, opt,
batch) -> (params, opt, metrics)`: the loss and the gradients of every
parameter by `torch.autograd.grad`, then `adamw_update`, which writes the
new parameters and moments in place. With `accum_steps > 1` the batch is
cut into that many micro-batches along its batch axis and their gradients
are summed into f32 buffers, micro-batch by micro-batch, then divided, as
the reference's `lax.scan` does; with one step the gradients stay in the
parameters' dtype, as `jax.value_and_grad` gives them. Attention runs the
flash kernel forward and backward (`kernels.ops`). With `shd` on a mesh
the parameters, moments and batch are DTensors (`train_shardings`,
`data.make_batch(..., shd)`) and the whole step runs under
`Shardings.implicit`.
"""

from __future__ import annotations

import torch

from ..models import ModelConfig, forward, lm_loss, param_specs
from ..models.sharding import NO_SHARDING, Shardings, is_dtensor, tree_map
from .optimizer import HParams, adamw_update, leaves, opt_specs


def _forward_kwargs(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k != "labels"}


def loss_fn(params, batch, cfg: ModelConfig, shd: Shardings | None = None):
    logits, _, aux = forward(params, cfg, shd=shd, **_forward_kwargs(batch))
    return lm_loss(logits, batch["labels"], aux, cfg.router_aux_loss)


def value_and_grad(params, batch, cfg: ModelConfig,
                   shd: Shardings | None = None):
    """(loss, grads): grads a tree like params, each in its parameter's
    dtype (zeros for a parameter the loss does not reach)."""
    shd = shd if shd is not None else NO_SHARDING
    with torch.enable_grad(), shd.implicit():
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        it = iter(flat)
        live = tree_map(lambda _: next(it), params, is_leaf=torch.is_tensor)
        loss = loss_fn(live, batch, cfg, shd)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    it = iter(_like(g, p) for g, p in zip(grads, flat))
    return loss.detach(), tree_map(lambda _: next(it), params,
                                   is_leaf=torch.is_tensor)


def _like(g, p):
    """The gradient of parameter `p`: zeros where the loss does not reach
    it; a DTensor gradient laid out as its parameter (a partial sum is
    reduced here, the data-parallel all-reduce or reduce-scatter)."""
    if g is None:
        return torch.zeros_like(p)
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def _micro(batch: dict, n: int, i: int) -> dict:
    """Micro-batch i of n: rows [i B/n, (i+1) B/n) of every field along its
    batch axis (axis 1 of the (3, B, S) M-RoPE positions, else axis 0)."""
    out = {}
    for k, x in batch.items():
        ax = 1 if k == "mrope_positions" else 0
        rows = x.shape[ax] // n
        out[k] = x.narrow(ax, i * rows, rows)
    return out


def make_train_step(cfg: ModelConfig, hp: HParams, accum_steps: int = 1,
                    shd: Shardings | None = None):
    shd = shd if shd is not None else NO_SHARDING

    def train_step(params, opt, batch):
        with shd.implicit():
            return _train_step(params, opt, batch)

    def _train_step(params, opt, batch):
        if accum_steps == 1:
            loss, grads = value_and_grad(params, batch, cfg, shd)
        else:
            grads = tree_map(lambda p: torch.zeros_like(p,
                                                        dtype=torch.float32),
                             params, is_leaf=torch.is_tensor)
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for i in range(accum_steps):
                lval, g = value_and_grad(params, _micro(batch, accum_steps, i),
                                         cfg, shd)
                for acc, gi in zip(leaves(grads), leaves(g)):
                    acc.add_(gi)
                loss = loss + lval
                del g
            for acc in leaves(grads):
                acc.div_(accum_steps)
            loss = loss / accum_steps
        params, opt, om = adamw_update(params, grads, opt, hp, cfg)
        return params, opt, {"loss": loss, **om}
    return train_step


def make_eval_step(cfg: ModelConfig, shd: Shardings | None = None):
    shd = shd if shd is not None else NO_SHARDING

    def eval_step(params, batch):
        with torch.no_grad(), shd.implicit():
            return loss_fn(params, batch, cfg, shd)
    return eval_step


def train_shardings(cfg: ModelConfig, shd: Shardings):
    """(param specs, optimizer-state specs) of the train step."""
    pspecs = param_specs(cfg, shd)
    return pspecs, opt_specs(pspecs)
