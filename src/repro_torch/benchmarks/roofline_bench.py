"""§Roofline summary: the dry run's roofline table, the twin of the
repository's `benchmarks/roofline_bench.py`.

Reads the dry-run records (runs/dryrun_single*.json, the newest by name,
as `python -m repro_torch.launch.dryrun` writes them in the reference's
format) and renders each cell's three modelled terms on the single-pod
(16, 16) mesh of TPU v5e chips: seconds of that modelled pod, not of the
card. If there are no records it says how to produce them instead of
tracing them here."""

from __future__ import annotations

import glob
import json


def run(report):
    paths = sorted(glob.glob("runs/dryrun_single*.json"))
    if not paths:
        report.note("no dry-run artifacts under runs/; generate with:\n"
                    "  PYTHONPATH=src python -m repro_torch.launch.dryrun "
                    "--arch all --shape all --mesh both --out "
                    "runs/dryrun_single.json")
        return
    path = paths[-1]
    with open(path) as f:
        records = json.load(f)
    report.section(f"Roofline (single-pod 16x16), from {path}")
    rows = []
    for r in records:
        if r.get("status") == "skip":
            rows.append({"cell": f'{r["arch"]}/{r["shape"]}',
                         "dominant": "SKIP", "compute_s": "-",
                         "memory_s": "-", "collective_s": "-",
                         "roofline_frac": r.get("reason", "")[:40]})
            continue
        if r.get("status") != "ok":
            rows.append({"cell": f'{r["arch"]}/{r["shape"]}',
                         "dominant": "FAIL", "compute_s": "-",
                         "memory_s": "-", "collective_s": "-",
                         "roofline_frac": r.get("error", "")[:40]})
            continue
        rf = r["roofline"]
        rows.append({"cell": rf["name"], "dominant": rf["dominant"],
                     "compute_s": f'{rf["compute_s"]:.3f}',
                     "memory_s": f'{rf["memory_s"]:.3f}',
                     "collective_s": f'{rf["collective_s"]:.4f}',
                     "roofline_frac": f'{rf["roofline_fraction"]:.3f}',
                     "mem_roof_frac": f'{rf.get("memory_roof_fraction", 0):.3f}'})
    report.table(rows)
    ok = [r for r in records if r.get("status") == "ok"]
    report.note(f"{len(ok)} traced cells, "
                f"{sum(1 for r in records if r.get('status') == 'skip')} "
                "documented skips. Full records (memory_analysis, "
                "collective schedule, guidance) in the JSON.")
