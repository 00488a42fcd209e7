"""Key Takeaways 1-3 as a benchmark: score workloads on both machines
(paper §II; `core.suitability`). The port's twin of the repository's
`benchmarks/suitability_bench.py`.

Scores (a) the PrIM reference programs (`prim.<workload>.ref`, n = 4096)
against the modelled UPMEM machine — the paper's own suitability
verdicts — and (b) the train, prefill and decode steps of REDUCED
granite-3-8b against the modelled TPU machine: decode is the PIM-suitable
stage (memory-bound GEMV), train and prefill are compute-bound.

The inputs and parameters are made on `device` (default: the card); the
census (`core.census`) traces their fake CPU twins, or, for a program that
reads values on the host, CPU copies. Nothing of this path runs on the
card and no kernel is launched: every number is a count of the program,
scored on a modelled machine. The train step's census holds its forward,
its backward (the autograd Function's CPU primitives: the plain attention
and its explicit gradient) and the AdamW update.
"""

from __future__ import annotations

import functools

import torch

from .. import prim
from ..configs import REDUCED
from ..core.census import analyze_program
from ..core.suitability import score
from ..device import resolve_device
from ..configs.shapes import ShapeConfig
from ..models import forward, init_cache, init_params
from ..train import DataConfig, HParams, adamw_init, make_batch, \
    make_train_step

PRIM_ROWS = ("VA", "GEMV", "SpMV", "BS", "RED", "SCAN-SSA", "TRNS", "TS",
             "HST-S")
PRIM_N = 4096
LM_ARCH = "granite-3-8b"
LM_SLOTS, LM_CACHE, LM_PROMPT = 4, 128, 64
LM_TRAIN = ShapeConfig("b", 64, 4, "train")


def prim_reports(device=None) -> list:
    """The suitability report of each PrIM row's `ref` at PRIM_N on the
    modelled UPMEM machine."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for name in PRIM_ROWS:
        inputs = prim.make_inputs(name, PRIM_N, gen, dev)
        # non-tensor params (e.g. HST's bin count) are static, not traced
        static = {k: v for k, v in inputs.items() if isinstance(v, int)}
        arrays = [v for v in inputs.values() if not isinstance(v, int)]
        fn = functools.partial(prim.WORKLOADS[name].ref, **static)
        out.append(score(analyze_program(fn, *arrays), name=name,
                         machine="upmem_2556"))
    return out


def lm_programs(device=None) -> dict:
    """name -> (fn, args) of the REDUCED granite-3-8b train step (4 x 64
    tokens, AdamW with default hyperparameters), prefill (4 x 64 tokens
    into a 4 x 128 cache) and decode (4 x 1) steps."""
    dev = resolve_device(device)
    cfg = REDUCED[LM_ARCH]
    params = init_params(0, cfg, device=dev)
    cache = init_cache(cfg, LM_SLOTS, LM_CACHE, device=dev)

    def step(p, c, t):
        return forward(p, cfg, tokens=t, cache=c)[0]
    batch = make_batch(cfg, LM_TRAIN, 0, DataConfig(), dev)
    return {
        "train": (make_train_step(cfg, HParams()),
                  (params, adamw_init(params, cfg), batch)),
        "prefill": (step, (params, cache, torch.ones(
            (LM_SLOTS, LM_PROMPT), dtype=torch.int32, device=dev))),
        "decode": (step, (params, cache, torch.ones(
            (LM_SLOTS, 1), dtype=torch.int32, device=dev))),
    }


def lm_reports(device=None) -> list:
    """The suitability report of each LM step on the modelled TPU v5e."""
    return [score(analyze_program(fn, *args), name=name, machine="tpu_v5e")
            for name, (fn, args) in lm_programs(device).items()]


def run(report, device=None):
    dev = resolve_device(device)
    report.section("PrIM kernels scored on the UPMEM machine (KT1-3)")
    rows = [{"workload": r.name,
             "OI(F/B)": round(r.operational_intensity, 3),
             "KT1 mem-bound": r.memory_bound,
             "KT2 simple-ops": r.simple_ops,
             "KT3 low-comm": r.low_comm,
             "PIM-suitable": r.pim_suitable} for r in prim_reports(dev)]
    report.table(rows)

    report.section("LM steps scored on the TPU machine (the decode thesis)")
    rows = [{"step": r.name,
             "OI(F/B)": round(r.operational_intensity, 1),
             "mem-bound": r.memory_bound,
             "balance": round(r.machine_balance, 1)}
            for r in lm_reports(dev)]
    report.table(rows)
    assert rows[-1]["mem-bound"], "decode must be memory-bound (the thesis)"
    report.note("decode sits far below the TPU balance point (a batched "
                "GEMV — PrIM's GEMV pattern), which is why the serving path "
                "uses the bank-parallel weight-stationary layout. Counts "
                "from the census of each program, scored on the modelled "
                "machines; no time was measured.")
