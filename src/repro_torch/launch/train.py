"""Training launcher: `python -m repro_torch.launch.train --arch granite-3-8b`.

Runs the fault-tolerant `TrainLoop` on one device: the card by default,
the CPU with `--device cpu` (with `--reduced` for CPU-sized configs).
Attention runs the flash kernel forward and backward on the card.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch mixtral-8x7b --reduced --device cpu --steps 100 --batch 8 \
        --seq 128 --ckpt-dir /tmp/run1   # rerun resumes from the latest

Every `--log-every`-th step (and the first) prints as a JSON line, then a
summary line. On the card
it also prints the kernels' launch counts of the run (by route), the
attention calls that ran on DTensor shards (`ops.SHARDED`) and the peak
device memory as one JSON line. `--mesh` trains on
`launch.mesh.make_smoke_mesh()` with `TRAIN_POLICY`: a (1, n) mesh over
the ranks of the running process group, or over a one-process group it
starts (NCCL on the card, gloo with `--device cpu`) and ends on exit.
Parameters, moments and batches are then DTensors and the flash kernels
run on each device's shard.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from ..configs import get_arch
from ..configs.shapes import ShapeConfig
from ..device import resolve_device
from ..kernels import ops
from ..models import TRAIN_POLICY, Shardings
from ..train import DataConfig, HParams, LoopConfig, TrainLoop
from .mesh import make_smoke_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10,
                    help="log the metrics of every n-th step (and step 1)")
    ap.add_argument("--mesh", action="store_true",
                    help="shard over the ranks of the process group "
                         "(a (1, n) mesh; one rank if there is no group)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    started = args.mesh and not torch.distributed.is_initialized()
    try:
        return _run(args, dev)
    finally:
        if started and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _run(args, dev) -> int:
    shd = None
    if args.mesh:
        shd = Shardings(make_smoke_mesh(device=dev.type), TRAIN_POLICY)
    cfg = get_arch(args.arch, reduced=args.reduced)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    hp = HParams(lr=args.lr, warmup_steps=args.warmup,
                 total_steps=args.steps)
    loop_cfg = LoopConfig(total_steps=args.steps,
                          ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir, log_every=args.log_every)
    loop = TrainLoop(cfg, shape, hp, loop_cfg, DataConfig(), device=dev,
                     shd=shd)

    state = loop.resume_or_init(args.seed)
    start = state.step
    if start:
        print(f"resumed from step {start}")
    kernels = ops.kernels()
    for k in (*kernels.values(), ops.SHARDED):
        k.reset()
    t0 = time.perf_counter()
    state = loop.run(state)
    dt = time.perf_counter() - t0
    toks = (state.step - start) * args.batch * args.seq
    for m in loop.metrics_log:
        print(json.dumps(m))
    print(f"done: {state.step} steps, {dt:.1f}s, "
          f"{toks / max(dt, 1e-9):.0f} tok/s, "
          f"stragglers={len(loop.straggler_steps)}")
    if dev.type == "cuda":
        print(json.dumps({
            "kernel_launches": {n: {"launches": k.launches,
                                    "routes": dict(k.route_launches)}
                                for n, k in kernels.items() if k.launches},
            "sharded_calls": dict(ops.SHARDED.route_launches),
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
