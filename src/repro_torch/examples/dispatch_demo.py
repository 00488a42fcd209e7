"""Hybrid dispatch demo: plan -> schedule -> execute a mixed workload.

Builds the mixed PrIM pipeline (streaming int phases around a
transpose/rotate middle), lets `repro_torch.dispatch` choose a
per-operator placement over the modelled CPU and 2556-DPU system, prints
the plan and the coalesced launch/transfer schedule, then executes the
hybrid plan (PIM stages as BankGrid phases, host stages as plain calls)
and checks the result against the single-device reference.

    PYTHONPATH=src python -m repro_torch.examples.dispatch_demo \
        [--m 512] [--model-m 4096] [--device cpu]

The twin of the repository's `examples/dispatch_demo.py`. The modelled
seconds are the planner's machines', not the card's.
"""

import argparse

from ..core.bank_parallel import BankGrid
from ..device import resolve_device
from ..dispatch import workloads
from ..dispatch.placement import compare_plans, plan
from ..dispatch.runtime import check_phase_discipline, execute
from ..dispatch.schedule import make_schedule


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.examples.dispatch_demo")
    ap.add_argument("--m", type=int, default=512,
                    help="matrix side for the executed pipeline")
    ap.add_argument("--model-m", type=int, default=4096,
                    help="matrix side for the paper-scale modeled plan")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- model at paper scale: the planner's three-way comparison --------
    g = workloads.mixed_pipeline(m=args.model_m, concrete=False).graph()
    print(f"== modeled at {args.model_m}x{args.model_m} int32 ==")
    for name, p in compare_plans(g).items():
        print(f"  {name:10s} {p.total_s * 1e3:9.3f}ms  "
              f"devices={'+'.join(p.used_devices)}")
    hybrid = plan(g)
    print()
    print(hybrid.render())
    print()
    print(make_schedule(g, hybrid).render())

    # --- execute the paper-scale placement for real at a reduced size ----
    # (at small sizes the planner rightly keeps everything on the host —
    # launch overhead dominates — so we run the at-scale assignment to
    # exercise both execution faces)
    print(f"\n== executing hybrid plan at {args.m}x{args.m} on {device} ==")
    pipe = workloads.mixed_pipeline(m=args.m, seed=0, device=device)
    grid = BankGrid(1, device)
    checked = check_phase_discipline(pipe, grid)
    rep = execute(pipe, hybrid, grid)
    print(f"  {checked} bank-local phases verified exchange-free")
    print(f"  stage placement: {rep.stage_devices}")
    print(f"  result matches single-device reference: {rep.matches} "
          f"(max |err| = {rep.max_abs_err:.3g})")
    return rep


if __name__ == "__main__":
    main()
