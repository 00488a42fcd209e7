"""The knee of an open-loop cell: its traffic at a few fixed rates, one
process, reporting per rate the tails, the generator's lateness and the
backlog the window leaves.

    python3 -m bench.sweep --workload granite-3-8b.docqa --rates 2,3,4,5 \
        --seconds 30 --seed 5 [--out results/sweep.json]

The knee is the highest rate whose backlog does not grow through the
window: the admissions run no later at its end than at its start, and the
drain after the window is short. The cell's rate is then fixed at about
four fifths of it. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from .run import ROOT, cache_dirs, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, default=1)
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
    for rate in (float(r) for r in args.rates.split(",")):
        out, run = run_cell(man, args.workload, args.seed, args.seconds,
                            False, t_start=time.perf_counter(),
                            mix={"rate_rps": rate}, judge=False,
                            log=lambda m: print(f"  {m}", file=sys.stderr))
        reqs = [r for r in run.served if r.due_at is not None]
        t0, t1 = run.window["t0"], run.window["t1"]
        late = [r.admit_at - r.due_at for r in reqs if r.admit_at]
        half = len(late) // 2
        done_at = max((r.token_times[-1] for r in reqs if r.token_times),
                      default=t1)
        row = {"rate_rps": rate, "requests": len(reqs),
               "failed": out["failed"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "late_first_half_s": sorted(late[:half])[half // 2] if half
               else None,
               "late_second_half_s": sorted(late[half:])[len(late[half:]) // 2]
               if late[half:] else None,
               "drain_s": done_at - t1,
               "admitted_after_window": sum(1 for r in reqs
                                            if r.admit_at and r.admit_at > t1),
               "engine": run.engine, "window_s": t1 - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
