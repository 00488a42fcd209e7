"""PrIM on a multi-bank grid: the UPMEM execution model made visible.

    PYTHONPATH=src python -m repro_torch.examples.prim_multibank [--device cpu]

Runs three workloads with very different communication structures on an
8-bank `BankGrid` and prints their phase anatomy:
  RED       local reduce        -> one cross-bank tree      (tiny comm)
  SCAN-SSA  local scan          -> bank-sum exchange -> add (tiny comm)
  NW        wavefront: B+R-1 steps, a boundary column crosses banks
            EVERY step (the paper's worst-fit pattern, Takeaway 3)

The twin of the repository's `examples/prim_multibank.py`. The port's
grid takes any bank count in one process (the banks are a leading
dimension on one device), so no fresh process is needed.
"""

import argparse
import time

import torch

from .. import prim
from ..core.bank_parallel import BankGrid
from ..device import resolve_device


def _leaves(x):
    return list(x) if isinstance(x, tuple) else [x]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.examples.prim_multibank")
    ap.add_argument("--banks", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    grid = BankGrid(args.banks, device)
    print(f"bank grid: {grid.n_banks} banks on {device} "
          "(DPU=bank, MRAM=shard, exchanges=tensor steps)\n")
    gen = torch.Generator(device=device).manual_seed(0)

    ok_all = True
    for name, n, phases in [
        ("RED", 1 << 16, "local reduce + 1 tree exchange"),
        ("SCAN-SSA", 1 << 16, "local scan + bank-sum exchange + local add"),
        ("NW", 128, "wavefront: boundary handshake EVERY anti-diagonal"),
    ]:
        mod = prim.WORKLOADS[name]
        inputs = mod.make_inputs(n, gen, device)
        t0 = time.perf_counter()
        got = mod.run_pim(grid, **inputs)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        ok = all(torch.equal(g, w) for g, w in
                 zip(_leaves(got), _leaves(mod.ref(**inputs))))
        ok_all &= ok
        c = mod.counts(n)
        print(f"{name:9s} n={n:6d}  correct={ok}  {dt:7.1f} ms "
              f"(first call, host clock)")
        print(f"          phases: {phases}")
        print(f"          model: {c.bytes_streamed / 1e6:.1f} MB streamed, "
              f"{c.interbank_bytes / 1e3:.1f} KB inter-bank "
              f"({'suitable' if c.pim_suitable else 'NOT suitable'} "
              "per Fig. 4)\n")
    return ok_all


if __name__ == "__main__":
    main()
