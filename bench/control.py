"""The control of a cell's comparison, and the program's readings beside
it, over several seeds in one process.

    python3 -m bench.control --workload <cell> --seeds 11,12,13 --seconds 30 \
        [--out results/control.json]

Each seed is a whole run of the cell (untraced) whose sample is compared
twice: the program's served tokens against the float32 reference (the
lower reading), and the reference computed in float8 e4m3, which is the
nearest precision below the bfloat16 the configuration states, read at
the same positions (the upper reading). A limit lies between the largest
lower and the smallest upper reading. Each seed also gives the control's
verdict under the cell's own limits, reached as the program's is: it has
to come out false. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from .run import ROOT, cache_dirs, forbidden_modules, run_cell


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
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
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out, _ = run_cell(man, args.workload, seed, args.seconds, False,
                          t_start=t0, control=True,
                          log=lambda m: print(f"  {m}", file=sys.stderr))
        ctl = out.get("control", {})
        row = {"seed": seed,
               "program": {k: v["value"] for k, v in out["checks"].items()},
               "control": ctl.get("numbers"),
               "correct": out["correct"], "control_correct": ctl.get("correct"),
               "metrics": out["metrics"],
               "program_gaps": ctl.get("program_gaps"),
               "control_gaps": ctl.get("control_gaps")}
        rows.append(row)
        print(json.dumps(row), flush=True)
    names = rows[0]["program"]
    lower = {k: max(r["program"][k] for r in rows) for k in names}
    upper = {k: min((r["control"][k] for r in rows if r["control"]),
                    default=None) for k in names}
    limits = {k: v["limit"] for k, v in out["checks"].items()}
    summary = {"workload": args.workload, "lower": lower, "upper": upper,
               "limits": limits,
               "program_correct": [r["correct"] for r in rows],
               "control_correct": [r["control_correct"] for r in rows],
               "rows": rows, "forbidden": forbidden_modules()}
    print(json.dumps({k: summary[k] for k in
                      ("workload", "lower", "upper", "limits",
                       "program_correct", "control_correct", "forbidden")}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
