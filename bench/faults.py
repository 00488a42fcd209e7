"""Faults planted under the timed path, to see `correct` come out false.

    python3 -m bench.faults --workload <cell> --seeds 11 --seconds 20 \
        --faults state_unchanged,half_batch [--out results/faults.json]

Each fault replaces one function of the program for the length of one
run of the cell (untraced), and the run is judged as every run is, under
the limits of the cell's file:
- `state_unchanged`: a decode step writes nothing into the KV cache;
- `half_batch`: decode attention returns zeros for every second slot,
  half of the live batch however many slots are in use (the engine fills
  the lowest free slot first, so an open loop's upper slots stay empty);
- `token_altered`: every sampled token is moved to the next id.
The benchmark's runs never plant one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

from .run import ROOT, cache_dirs, run_cell


def state_unchanged(patch) -> None:
    from repro_torch.models import cache
    patch(cache, "write_decode", lambda kv, k, v, index, width: kv)


def half_batch(patch) -> None:
    from repro_torch.models import layers
    real = layers.cached_attention

    def half(q, *args, **kwargs):
        out = real(q, *args, **kwargs)
        out[1::2] = 0
        return out
    patch(layers, "cached_attention", half)


def token_altered(patch) -> None:
    from repro_torch.serve import engine
    real = engine.sample

    def altered(logits, *args, **kwargs):
        return (real(logits, *args, **kwargs) + 1) % logits.shape[-1]
    patch(engine, "sample", altered)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered}


@contextlib.contextmanager
def planted(name: str):
    """Fault `name` in place until the block ends."""
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)
    try:
        FAULTS[name](patch)
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default=",".join(FAULTS))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    os.environ.update(cache_dirs(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from .manifest import Manifest
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    man = Manifest(ROOT)
    rows = []
    for name in args.faults.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            with planted(name), torch.no_grad():
                out, _ = run_cell(man, args.workload, seed, args.seconds,
                                  False, t_start=t0,
                                  log=lambda m: print(f"  {m}",
                                                      file=sys.stderr))
            row = {"workload": args.workload, "fault": name, "seed": seed,
                   "correct": out["correct"], "failed": out["failed"],
                   "checks": out["checks"]}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
