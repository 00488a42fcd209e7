"""Quickstart: the paper's methodology end to end in seconds.

1. run a PrIM workload in the bank-parallel execution model,
2. characterize it with the census and the KT1-3 suitability verdict,
3. reproduce the paper's headline Fig. 4 numbers from the calibrated model.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The twin of the repository's `examples/quickstart.py`: the census of the
workload's `ref` is `core.census.analyze_program` (traced on fake CPU
tensors) where the reference compiles it and reads the HLO.
"""

import argparse

import torch

from .. import prim
from ..core.bank_parallel import BankGrid
from ..core.census import analyze_program
from ..core.perf_model import Figure4, compare
from ..core.suitability import score
from ..device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.examples.quickstart")
    ap.add_argument("--n", type=int, default=1 << 16,
                    help="SCAN-SSA input length")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. a PrIM workload on the bank-parallel model ------------------
    grid = BankGrid(1, device)
    mod = prim.WORKLOADS["SCAN-SSA"]
    gen = torch.Generator(device=device).manual_seed(0)
    inputs = mod.make_inputs(args.n, gen, device)
    out = mod.run_pim(grid, **inputs)
    ok = bool(torch.equal(out, mod.ref(**inputs)))
    print(f"SCAN-SSA on {grid.n_banks} bank(s) ({device}): correct={ok}")

    # --- 2. characterize it (the paper's Key Takeaways as code) ---------
    rep = score(analyze_program(mod.ref, inputs["x"]), name="SCAN-SSA",
                machine="upmem_2556")
    for line in rep.takeaways:
        print(" ", line)
    print(f"  => PIM-suitable: {rep.pim_suitable}")

    # --- 3. the paper's headline comparison (calibrated model) ----------
    fig = Figure4([compare(c) for c in prim.all_ref_counts()])
    print(f"\n2556-DPU vs CPU : {fig.avg_speedup_2556_vs_cpu:5.1f}x "
          "(paper: 23.2x)")
    print(f"640-DPU  vs CPU : {fig.avg_speedup_640_vs_cpu:5.1f}x "
          "(paper: 10.1x)")
    print(f"2556-DPU vs GPU : {fig.avg_speedup_2556_vs_gpu_suitable:5.2f}x "
          "on the 10 suitable benchmarks (paper: 2.54x)")
    print(f"energy eff. 640 : {fig.avg_energy_eff_640_vs_cpu:5.2f}x "
          "(paper: 1.64x)")
    return ok


if __name__ == "__main__":
    main()
