"""Phase 18 (a)'s meshed training step in two checkouts, in turns on one
card.

    python3 mesh_pair.py PARENT CHANGE

PARENT and CHANGE are directories that each hold a checkout of the
repository (for example `git archive <commit>` unpacked into an ignored
directory). In the order P C C P every letter starts one process in that
checkout that imports its `chip_smoke` and `repro_torch`, builds its
kernels and runs `chip_smoke.mesh_train_path` with MESH_STEPS steps
(granite-3-8b at published widths, 8 layers, bf16, B 2 x 4096, without a
mesh and then on a (1, 1) NCCL mesh, every leaf held bit-equal). Prints
one JSON line a process (median ms/step without and with the mesh, each
run's seconds) and writes them all to chiprun_out/mesh_pair.json. Needs
one CUDA card; the processes run one at a time.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ORDER = "PCCP"
MESH_STEPS = 6
OUT = HERE / "chiprun_out" / "mesh_pair.json"

# runs in one process, from the checkout's root
CHILD = f"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import chip_smoke
chip_smoke.MESH_STEPS = {MESH_STEPS}
from repro_torch.kernels import _build, ops
_build.build_all()
_, out = chip_smoke.mesh_train_path(ops.kernels())
print(json.dumps({{k: out[side][m] for side, k, m in (
    ("plain", "plain_ms", "ms_per_step"), ("mesh", "mesh_ms", "ms_per_step"),
    ("plain", "plain_run_s", "run_s"), ("mesh", "mesh_run_s", "run_s"))}}))
"""


def main(argv) -> int:
    trees = {"P": Path(argv[1]).resolve(), "C": Path(argv[2]).resolve()}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    runs = []
    for side in ORDER:
        tree = trees[side]
        r = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                           env=dict(os.environ, PYTHONPATH=str(tree / "src")),
                           capture_output=True, text=True)
        line = [x for x in r.stdout.splitlines() if x.startswith('{"plain')]
        if r.returncode or not line:
            print(f"{side} ({tree}) exited {r.returncode}:\n"
                  f"{r.stderr[-3000:]}", file=sys.stderr)
            return 1
        runs.append(dict(json.loads(line[0]), side=side))
        print(json.dumps(runs[-1]), flush=True)
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
