"""`BENCHMARK.json` and the files it names, found by name: a cell's
configuration in `bench/configs/<config>.json`, its traffic mix in
`bench/workloads/<cell>.json`, each metric's reader in
`bench/metrics/<metric>.py`. A configuration file's `reference` names
its plain reference, `bench/reference/<reference>.py`, and its family,
`bench/families/<reference>.py`. A model is added with its configuration
file, and with its family module and its reference where its kind of
stack is new; a mix or a metric by adding its file; each with its
entry. Nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


class Manifest:
    """The benchmark rooted at checkout `root`."""

    def __init__(self, root):
        self.root = Path(root)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "bench"

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        """The traffic mix file of cell `name`."""
        return json.loads((self.dir / "workloads" / f"{name}.json")
                          .read_text())

    def metrics(self, cell: str, trace: bool) -> list[dict]:
        """The metrics a run of `cell` reports: its end-to-end metrics
        (`trace` false) or its per-layer metrics (`trace` true); a metric
        without `workloads` is every cell's."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The `read(run)` of metric `metric`'s module."""
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"bench.metrics.{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def problems(data: dict, root) -> list[str]:
    """What in a manifest breaks the naming rules or leaves a name without
    its file; empty when it is sound."""
    root = Path(root)
    out = []
    names = ([c["name"] for c in data["configs"]]
             + [w["name"] for w in data["workloads"]]
             + [m["name"] for m in data["end_to_end"] + data["per_layer"]])
    for n in names:
        if not NAME.match(n):
            out.append(f"bad name {n!r}")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [x["name"] for x in data[group]]
        if len(seen) != len(set(seen)):
            out.append(f"a name repeats in {group}")
    for c in data["configs"]:
        if not (root / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
        else:
            out += _modules(c["name"], json.loads((root / c["file"])
                                                  .read_text()), root)
        for k in c["reduced"]:
            if not NAME.match(k):
                out.append(f"bad reduced key {k!r}")
    for w in data["workloads"]:
        if not (root / "bench" / "workloads" / f"{w['name']}.json").is_file():
            out.append(f"cell {w['name']}: no traffic file")
        for k in ("config", "traffic"):
            if not NAME.match(w[k]):
                out.append(f"cell {w['name']}: bad {k} {w[k]!r}")
    for m in data["end_to_end"] + data["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"metric {m['name']}: bad unit {m['unit']!r}")
        if not (root / "bench" / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"metric {m['name']}: no reader")
    cells = {w["name"] for w in data["workloads"]}
    e2e = {m["name"]: m for m in data["end_to_end"]}
    for m in data["per_layer"]:
        moved = e2e.get(m["moves"])
        if moved is None:
            out.append(f"metric {m['name']}: moves unknown {m['moves']!r}")
            continue
        for cell in m.get("workloads", cells):
            if cell not in moved.get("workloads", cells):
                out.append(f"metric {m['name']}: cell {cell} does not "
                           f"report {m['moves']}")
    return out


def _modules(name: str, file: dict, root: Path) -> list[str]:
    """What configuration file `file`'s `reference` names without a module
    for it: its family and its plain reference."""
    module = file.get("reference")
    return [f"config {name}: no {kind} module {module!r}"
            for kind, folder in (("family", "families"),
                                 ("reference", "reference"))
            if not (isinstance(module, str) and NAME.match(module)
                    and (root / "bench" / folder / f"{module}.py").is_file())]
