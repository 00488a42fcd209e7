"""Training launcher: `python -m repro_torch.launch.train --arch granite-3-8b`.

Runs the fault-tolerant `TrainLoop` on one device: the card by default,
the CPU with `--device cpu` (with `--reduced` for CPU-sized configs).
Attention runs the flash kernel forward and backward on the card.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch mixtral-8x7b --reduced --device cpu --steps 100 --batch 8 \
        --seq 128 --ckpt-dir /tmp/run1   # rerun resumes from the latest

Every `--log-every`-th step (and the first) prints as a JSON line, then a
summary line. On the card
it also prints the kernels' launch counts of the run (by route) and the
peak device memory as one JSON line. `--mesh` (sharding over several
devices) comes with `launch.mesh` (ROADMAP Queue 1, item 18c).
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
from ..train import DataConfig, HParams, LoopConfig, TrainLoop


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
                    help="shard over all local devices (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh comes with launch.mesh (ROADMAP Queue 1, item 18c); "
            "the port trains on one device")

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch, reduced=args.reduced)
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    hp = HParams(lr=args.lr, warmup_steps=args.warmup,
                 total_steps=args.steps)
    loop_cfg = LoopConfig(total_steps=args.steps,
                          ckpt_every=args.ckpt_every,
                          ckpt_dir=args.ckpt_dir, log_every=args.log_every)
    loop = TrainLoop(cfg, shape, hp, loop_cfg, DataConfig(), device=dev)

    state = loop.resume_or_init(args.seed)
    start = state.step
    if start:
        print(f"resumed from step {start}")
    kernels = ops.kernels()
    for k in kernels.values():
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
            "peak_bytes": torch.cuda.max_memory_allocated(dev)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
