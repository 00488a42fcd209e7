"""Benchmark orchestrator of the port — one module per paper figure:

  microbench        Fig. 2 (throughput vs OI), Fig. 3 (op/dtype throughput)
  prim_bench        Table I (16 PrIM workloads, bank-parallel vs oracle),
                    Fig. 4 (cross-system model)
  suitability_bench Key Takeaways 1-3 (the census of each program, scored
                    on the modelled UPMEM and TPU machines)
  scaling_bench     strong scaling vs #DPUs (full-paper §5.2, modelled)
  dispatch_bench    pure-CPU vs pure-PIM vs hybrid offload plans
                    (decode + chunked prefill, serial vs overlapped),
                    executed reduced pipelines, dispatch-backed serving
  gateway_bench     serving gateway under seeded Poisson traffic:
                    sustained req/s + tail latency, plan-cache hit
                    rate, overload goodput, paper-scale projection
  roofline_bench    §Roofline: the dry run's table (runs/dryrun_single*.json
                    from `launch.dryrun`), modelled TPU v5e pod terms

Run: PYTHONPATH=src python -m repro_torch.benchmarks.run [module ...]
                                  [--device DEV] [--quick] [--trace OUT_JSON]

`--device` defaults to the card (cuda); `--device cpu` runs the plain
PyTorch versions on the CPU. Asking for the card where there is none
raises before any module runs. `--quick` runs a module's reduced smoke
sweep where it has one (dispatch_bench, gateway_bench); `--trace
OUT_JSON` goes to the modules that take `trace_out` (a measured
execution trace written as JSON plus its Chrome trace_event twin).
Each module gets the keywords its `run` takes.
"""

from __future__ import annotations

import argparse
import inspect
import time

from ..device import resolve_device


class Report:
    """Plain-text table/section sink (markdown-ish, CSV-friendly)."""

    def section(self, title: str):
        print(f"\n## {title}\n")

    def note(self, text: str):
        print(f"  NOTE: {text}")

    def raw(self, text: str):
        print(text)

    def table(self, rows: list[dict]):
        if not rows:
            print("  (empty)")
            return
        cols = list(rows[0].keys())
        print("| " + " | ".join(cols) + " |")
        print("|" + "|".join("---" for _ in cols) + "|")
        for r in rows:
            print("| " + " | ".join(str(r.get(c, "")) for c in cols) + " |")


def main(argv=None) -> int:
    from . import (dispatch_bench, gateway_bench, microbench, prim_bench,
                   roofline_bench, scaling_bench, suitability_bench)
    modules = {"microbench": microbench, "prim_bench": prim_bench,
               "suitability_bench": suitability_bench,
               "scaling_bench": scaling_bench,
               "dispatch_bench": dispatch_bench,
               "gateway_bench": gateway_bench,
               "roofline_bench": roofline_bench}
    ap = argparse.ArgumentParser(prog="repro_torch.benchmarks.run")
    ap.add_argument("modules", nargs="*", metavar="module",
                    help=f"any of {list(modules)} (default: all)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--quick", action="store_true",
                    help="a module's reduced smoke sweep, where it has one")
    ap.add_argument("--trace", default=None, metavar="OUT_JSON",
                    help="write a measured execution trace (modules that "
                         "take trace_out)")
    args = ap.parse_args(argv)
    unknown = [m for m in args.modules if m not in modules]
    if unknown:
        ap.error(f"unknown modules {unknown}; choose from {list(modules)}")
    device = resolve_device(args.device)
    names = args.modules or list(modules)
    report = Report()
    t0 = time.perf_counter()
    failed = []
    for name in names:
        print(f"\n{'=' * 72}\n= repro_torch.benchmarks.{name} on {device}"
              f"\n{'=' * 72}")
        try:
            run_fn = modules[name].run
            params = inspect.signature(run_fn).parameters
            kw = {k: v for k, v in (("device", device),
                                    ("quick", args.quick),
                                    ("trace_out", args.trace))
                  if k in params}
            run_fn(report, **kw)
        except Exception:  # keep the harness going, report at end
            import traceback
            traceback.print_exc()
            failed.append(name)
    print(f"\n{'=' * 72}")
    print(f"done in {time.perf_counter() - t0:.1f}s; "
          f"{len(names) - len(failed)}/{len(names)} benchmark modules ok"
          + (f"; FAILED: {failed}" if failed else ""))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
