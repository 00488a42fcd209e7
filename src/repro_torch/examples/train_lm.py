"""End-to-end training driver: train a ~100M-parameter dense LM for a few
hundred steps with the full stack — fault-tolerant loop, atomic
checkpoints, deterministic data pipeline, straggler tracking; on the card
its attention runs the flash kernels forward and backward.

Interrupt it (Ctrl-C) and re-run: it resumes from the latest checkpoint
and reproduces the uninterrupted trajectory bit for bit.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \
        --steps 20

The twin of the repository's `examples/train_lm.py`; the weights and
batches come from torch generators, so its numbers are not the
reference's.
"""

import argparse
import os
import tempfile
import time

from ..configs.shapes import ShapeConfig
from ..device import resolve_device
from ..models import ModelConfig
from ..train import DataConfig, HParams, LoopConfig, TrainLoop


def make_100m() -> ModelConfig:
    """~100M params: a llama-style dense decoder."""
    return ModelConfig(
        name="demo-100m", family="dense",
        n_layers=12, d_model=576, n_heads=8, n_kv_heads=4, d_ff=2304,
        vocab_size=32000, rope_theta=1e4, q_chunk=64, kv_chunk=64,
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.examples.train_lm")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = make_100m()
    print(f"model: {cfg.name}, {cfg.param_count() / 1e6:.1f}M params, "
          f"on {dev}")

    shape = ShapeConfig("train", args.seq, args.batch, "train")
    loop = TrainLoop(
        cfg, shape,
        HParams(lr=1e-3, warmup_steps=20, total_steps=args.steps),
        LoopConfig(total_steps=args.steps, ckpt_every=50,
                   ckpt_dir=args.ckpt_dir, log_every=20),
        DataConfig(seed=1234), device=dev)

    state = loop.resume_or_init()
    start = state.step
    if start:
        print(f"resumed from checkpoint at step {start}")
    t0 = time.perf_counter()
    state = loop.run(state)
    dt = time.perf_counter() - t0

    for m in loop.metrics_log:
        print(f"  step {m['step']:4d}  loss {m['loss']:.4f}  "
              f"lr {m['lr']:.2e}  gnorm {m['grad_norm']:.2f}")
    tok_s = (state.step - start) * args.batch * args.seq / max(dt, 1e-9)
    print(f"\ndone: {state.step} steps in {dt:.0f}s (~{tok_s:.0f} tok/s "
          f"on {dev}), {len(loop.straggler_steps)} straggler steps flagged")
    if loop.metrics_log:
        first, last = (loop.metrics_log[0]["loss"],
                       loop.metrics_log[-1]["loss"])
        print(f"loss: {first:.3f} -> {last:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
