"""Elastic-restart validation, the counterpart of `repro.launch.elastic`: a
checkpoint taken on one mesh restores and trains on a different mesh
(scale-down after losing a pod, scale-up after repair).

Checkpoints are mesh-agnostic by construction (whole leaves, `full_tensor`
on save; target placements supplied at restore), so elasticity is a
restore with the new mesh's shardings. This module shows it end to end on
a REDUCED config with 8 CPU ranks of a gloo process group, which it spawns
itself (`torch.multiprocessing`):

    PYTHONPATH=src python -m repro_torch.launch.elastic --arch granite-3-8b

It trains 4 steps on a (2, 4) ("data", "model") mesh, checkpoints,
continues 2 steps on (2, 4) (the reference trajectory), restores onto
(1, 8) and (4, 2), trains 2 steps on each, and asserts their losses stay
within 5e-2 of the continuation (same data, same math: sharding changes
only the order of sums). CPU only: one card cannot hold 8 NCCL ranks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import tempfile

import torch
import torch.distributed as dist

from ..configs import get_arch
from ..configs.shapes import ShapeConfig
from ..models import TRAIN_POLICY, Shardings, init_params, param_defs
from ..models.sharding import tree_map
from ..train import (DataConfig, HParams, adamw_init, make_batch,
                     make_train_step, restore, save)

#: the reference's drift gate (its elastic.py)
DRIFT = 5e-2


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def run_on_mesh(cfg, shd, state, shape_cfg, hp, steps, start_step):
    """`steps` train steps from `start_step` on `shd`'s mesh. Returns the
    state and the losses."""
    step_fn = make_train_step(cfg, hp, shd=shd)
    params, opt = state
    losses = []
    for s in range(start_step, start_step + steps):
        batch = make_batch(cfg, shape_cfg, s, DataConfig(), "cpu", shd)
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
    return (params, opt), losses


def _targets(cfg, shd):
    """The restore targets of {"params", "opt"} on `shd`'s mesh: each
    leaf's (mesh, placements); the optimizer's step stays a plain
    tensor."""
    named = tree_map(lambda d: shd.named(d.shape, d.kinds, d.name),
                     param_defs(cfg))
    return {"params": named, "opt": {"m": named, "v": named, "step": None}}


def elastic_run(cfg, first, pre_steps, later, post_steps, ckpt: str,
                hp: HParams, shape_cfg: ShapeConfig) -> dict:
    """On this rank (of a process group spanning every mesh): `pre_steps`
    on mesh `first`, a checkpoint, then `post_steps` on `first` and on each
    mesh of `later`, each restored from the checkpoint. Returns {"pre":
    losses, mesh shape as a string: losses after the restore}."""
    shd = Shardings(_mesh(first), TRAIN_POLICY)
    params = init_params(0, cfg, "cpu", shd)
    opt = adamw_init(params, cfg)
    (params, opt), pre = run_on_mesh(cfg, shd, (params, opt), shape_cfg,
                                     hp, pre_steps, 0)
    like = {"params": params, "opt": opt}
    save(ckpt, pre_steps, like)
    out = {"pre": pre}
    for shape in (first,) + tuple(later):
        shd_b = Shardings(_mesh(shape), TRAIN_POLICY)
        tree = restore(ckpt, pre_steps, like, _targets(cfg, shd_b))
        _, post = run_on_mesh(cfg, shd_b, (tree["params"], tree["opt"]),
                              shape_cfg, hp, post_steps, pre_steps)
        out[str(shape)] = post
    return out


def _worker(rank: int, world: int, port: int, job: dict) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        torch.set_num_threads(1)     # one core a rank: the ranks share a host
        cfg = get_arch(job["arch"], reduced=True)
        if job.get("dtype"):
            cfg = dataclasses.replace(cfg, dtype=job["dtype"])
        out = elastic_run(cfg, tuple(job["first"]), job["pre_steps"],
                          [tuple(s) for s in job["later"]],
                          job["post_steps"], job["ckpt"],
                          HParams(**job["hp"]), ShapeConfig(*job["shape"]))
        if rank == 0:
            with open(job["out"], "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(job: dict, world: int) -> dict:
    """Run `job` on `world` CPU ranks (spawned processes, a gloo group on a
    free localhost port); returns rank 0's result."""
    import torch.multiprocessing as mp
    mp.spawn(_worker, args=(world, _free_port(), job), nprocs=world,
             join=True)
    with open(job["out"]) as f:
        return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one)")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as tmp:
        job = {"arch": args.arch, "first": (2, 4), "pre_steps": 4,
               "later": [(1, 8), (4, 2)], "post_steps": 2,
               "ckpt": args.ckpt or os.path.join(tmp, "ckpt"),
               "out": os.path.join(tmp, "losses.json"),
               "hp": {"lr": 1e-3, "warmup_steps": 2, "total_steps": 100},
               "shape": ("t", 32, 8, "train")}
        out = spawn(job, 8)
    print(f"trained 4 steps on (2, 4), losses "
          f"{[round(x, 4) for x in out['pre']]}")
    ref = out[str((2, 4))]
    for shape in ((1, 8), (4, 2)):
        post = out[str(shape)]
        drift = max(abs(a - b) for a, b in zip(ref, post))
        print(f"resumed on {shape}: losses {[round(x, 4) for x in post]} "
              f"(drift vs original mesh {drift:.2e})")
        assert drift < DRIFT, drift
    print("elastic restart OK: same trajectory on every mesh")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
