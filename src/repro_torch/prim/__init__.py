"""PrIM — the 16-workload benchmark suite of the paper (Table I), on the
port's bank-parallel grid (`core.bank_parallel.BankGrid`): the twin of
`repro.prim`. The bank-local phases of VA, GEMV, MLP, RED, SCAN-SSA,
SCAN-RSS, HST-S, HST-L, TS and TRNS run on the port's kernels
(`kernels.ops`); SEL, UNI, BS, SpMV, BFS and NW, which no Pallas kernel
covers in the reference, are plain torch.

Registry: WORKLOADS maps short name -> module; HST-L shares the hst module
with a different bin count (the paper's S/L distinction is bins-per-WRAM).
"""

from . import bfs, bs, gemv, hst, mlp, nw, red, scan_rss, scan_ssa, sel, \
    spmv, trns, ts, uni, va

WORKLOADS = {
    "VA": va, "GEMV": gemv, "SpMV": spmv, "SEL": sel, "UNI": uni,
    "BS": bs, "TS": ts, "BFS": bfs, "MLP": mlp, "NW": nw,
    "HST-S": hst, "HST-L": hst, "RED": red, "SCAN-SSA": scan_ssa,
    "SCAN-RSS": scan_rss, "TRNS": trns,
}

#: paper Fig. 4 grouping (group 1 = "more suitable")
SUITABLE_SET = {n for n, m in WORKLOADS.items() if m.SUITABLE}


def make_inputs(name: str, n: int, gen, device=None) -> dict:
    """The inputs of workload `name` at size n (HST-L at its bin count)."""
    mod = WORKLOADS[name]
    if name == "HST-L":
        return mod.make_inputs(n, gen, device, bins=mod.BINS_L)
    return mod.make_inputs(n, gen, device)


def all_counts(n: int):
    """WorkloadCounts for all 16 at a common scale n (perf model input)."""
    out = []
    for name, mod in WORKLOADS.items():
        if name == "HST-L":
            out.append(mod.counts_l(n))
        else:
            out.append(mod.counts(n))
    return out


def all_ref_counts():
    """WorkloadCounts at each workload's paper-scale reference size
    (module REF_N) — what the Fig-4 comparison validates against."""
    out = []
    for name, mod in WORKLOADS.items():
        if name == "HST-L":
            out.append(mod.counts_l(mod.REF_N))
        else:
            out.append(mod.counts(mod.REF_N))
    return out
