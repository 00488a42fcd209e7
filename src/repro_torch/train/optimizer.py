"""AdamW in PyTorch, the counterpart of `repro.train.optimizer`.

Moments live in `cfg.opt_moment_dtype` (f32 by default). The update math is
the reference's (decoupled weight decay, bias correction, global-norm
clipping) with its casts in its order: clipped gradients go back to their
dtype, the moments are computed in f32 and stored in the moment dtype, the
new parameter is computed in f32 and cast back. Scalars (the step, the
learning rate, the clip scale) are 0-dim tensors on the parameters'
device, so a step never waits on the host.

Unlike the reference's pure function, `adamw_update` writes the new
parameters and moments into the tensors it is given, leaf by leaf, with f32
temporaries for one leaf at a time: at full width a stacked leaf is
gigabytes per f32 copy, and a copy of every leaf would not fit beside the
weights. On a mesh the moments are DTensors laid out as their parameters
(`opt_specs`: ZeRO-style, the FSDP axis shards both) and the update runs
leaf by leaf on each device's shard; the global norm's sums become one
all-reduce.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models import ModelConfig, torch_dtype
from ..models.sharding import P, is_dtensor, tree_map


@dataclasses.dataclass(frozen=True)
class HParams:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def leaves(tree) -> list:
    """The tensors of a nested dict/list tree in `jax.tree` order (dict
    keys sorted, lists and tuples in order)."""
    out = []
    tree_map(out.append, tree, is_leaf=torch.is_tensor)
    return out


def schedule(step, hp: HParams) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac, in f32 as the
    reference computes it. step: an int or an int tensor."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(hp.warmup_steps, 1)
    t = torch.clamp((s - hp.warmup_steps)
                    / max(hp.total_steps - hp.warmup_steps, 1), 0.0, 1.0)
    cos = hp.min_lr_frac + (1 - hp.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return hp.lr * torch.where(s < hp.warmup_steps, warm, cos)


def adamw_init(params, cfg: ModelConfig) -> dict:
    """Zero moments in cfg.opt_moment_dtype, same tree (and, for DTensor
    parameters, the same placements) as params; the step a 0-dim int32 on
    the parameters' device."""
    mdt = torch_dtype(cfg.opt_moment_dtype)

    def zeros(p):
        if is_dtensor(p):
            return torch.zeros_like(p, dtype=mdt)
        return torch.zeros(p.shape, dtype=mdt, device=p.device)
    dev = leaves(params)[0].device
    return {"m": tree_map(zeros, params, is_leaf=torch.is_tensor),
            "v": tree_map(zeros, params, is_leaf=torch.is_tensor),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares in f32, the leaves
    added left to right from 0 as `jax.tree.reduce` folds them."""
    total = None
    for g in leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def clip_by_global_norm(grads, clip: float):
    """(grads scaled to a global norm of at most `clip`, each cast back to
    its dtype, and the norm before clipping)."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, clip)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads, is_leaf=torch.is_tensor), gnorm


def _clip_scale(gnorm, clip: float):
    """min(1, clip / max(gnorm, 1e-9)), a true division as the reference's
    (a Python float over a tensor would multiply by the reciprocal)."""
    clip = torch.full_like(gnorm, clip)
    return torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)


def adamw_update(params, grads, opt, hp: HParams, cfg: ModelConfig):
    """One AdamW step, written in place into `params` and `opt` (m, v and
    step). Returns (params, opt, metrics) with metrics grad_norm and lr,
    0-dim f32 tensors."""
    step = opt["step"] + 1
    lr = schedule(step, hp)
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, hp.clip_norm)
    b1, b2 = hp.b1, hp.b2
    sf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.full_like(sf, b1), sf)
    bc2 = 1.0 - torch.pow(torch.full_like(sf, b2), sf)
    f32 = torch.float32
    with torch.no_grad():
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt["m"]),
                              leaves(opt["v"])):
            gf = g.to(f32, copy=True).mul_(scale)
            if g.dtype != f32:                  # the clipped grad's dtype
                gf = gf.to(g.dtype).to(f32)
            m32 = m.to(f32, copy=True).mul_(b1).add_(gf * (1 - b1))
            v32 = v.to(f32, copy=True).mul_(b2).add_(
                gf.square_().mul_(1 - b2))
            del gf
            m.copy_(m32)
            v.copy_(v32)
            delta = m32.div_(bc1).div_(v32.div_(bc2).sqrt_().add_(hp.eps))
            del v32
            delta.add_(p.to(f32) * hp.weight_decay)
            p.copy_(p.to(f32).sub_(delta.mul_(lr)))
        opt["step"].copy_(step)
    return params, opt, {"grad_norm": gnorm, "lr": lr}


def opt_specs(param_specs_tree, moment_specs_tree=None):
    """PartitionSpec tree for the optimizer state, mirroring the params."""
    mspec = (moment_specs_tree if moment_specs_tree is not None
             else param_specs_tree)
    return {"m": mspec, "v": mspec, "step": P()}
