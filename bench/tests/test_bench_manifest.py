"""`BENCHMARK.json` against the contract's rules, a cell added by files
alone, and what a run may import."""

import json
import math
import subprocess
import sys
import time

import pytest

from bench import manifest
from bench.manifest import Manifest
from bench.run import forbidden_modules, run_cell
from bench.tests.tiny import ROOT, make_tree

DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_manifest_names_a_file_for_everything():
    assert manifest.problems(DATA, ROOT) == []


def test_manifest_keys_and_limits():
    assert set(DATA) == {"command", "paths", "run_seconds", *KEYS}
    for group, keys in KEYS.items():
        for entry in DATA[group]:
            extra = set(entry) - keys
            assert extra <= ({"workloads"} if group in ("end_to_end",
                                                        "per_layer")
                             else set()), (entry["name"], extra)
            assert keys <= set(entry)
    assert 1 <= DATA["run_seconds"] <= 51
    for m in DATA["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        assert m["better"] in ("lower", "higher")
    # a full check with 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (DATA["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200


def test_every_departure_from_the_source_is_in_reduced():
    for c in DATA["configs"]:
        file = json.loads((ROOT / c["file"]).read_text())
        assert set(file.get("departures", {})) <= set(c["reduced"]), c["name"]


def test_every_mix_names_its_sources():
    for w in DATA["workloads"]:
        mix = json.loads((ROOT / "bench" / "workloads" /
                          f"{w['name']}.json").read_text())
        assert mix["sources"] and all(isinstance(s, str)
                                      for s in mix["sources"]), w["name"]


@pytest.mark.parametrize("name,ok", [
    ("granite-3-8b.docqa", True), ("a_b.c-d", True), ("x" * 64, True),
    ("x" * 65, False), ("a b", False), ("a/b", False), ("-a", False),
    ("a,b", False), ("café", False)])
def test_name_rule(name, ok):
    assert bool(manifest.NAME.match(name)) is ok


@pytest.mark.parametrize("unit,ok", [
    ("tokens/s", True), ("%", True), ("ms", True), ("us", True),
    ("tokens per second", False), ("µs", False), ("", False)])
def test_unit_rule(unit, ok):
    assert bool(manifest.UNIT.match(unit)) is ok


def test_every_cell_reports_what_it_must():
    man = Manifest(ROOT)
    e2e = {m["name"] for m in DATA["end_to_end"]}
    for cell in (w["name"] for w in DATA["workloads"]):
        ends = {m["name"] for m in man.metrics(cell, False)}
        layers = man.metrics(cell, True)
        assert "setup_s" in ends and len(ends) >= 2 and layers
        # each per-layer metric moves an end-to-end metric this cell reports
        for m in layers:
            assert m["moves"] in ends & e2e, (cell, m["name"])
        # a kernel's roofline stands beside a whole-step mfu that moves
        # the same end-to-end metric
        for m in layers:
            if m["name"].endswith("_roofline"):
                assert m["unit"] == "%"
                assert any("mfu" in x["name"].split(".")
                           and x["moves"] == m["moves"] for x in layers)


def test_moves_must_be_reported_in_the_cell():
    bad = json.loads(json.dumps(DATA))
    m = next(x for x in bad["per_layer"] if x["name"] == "model.mfu.docqa")
    m["workloads"] = ["granite-3-8b.decode-64"]
    assert any("does not report ttft_p95_ms" in p
               for p in manifest.problems(bad, ROOT))


@pytest.mark.parametrize("value,only_in,says", [
    ("decoder", None, []),
    ("nowhere", None, ["family", "reference"]),
    ("../decoder", None, ["family", "reference"]),
    ("solo", "reference", ["family"]),
    ("solo", "families", ["reference"])])
def test_a_config_names_its_family_and_reference(tmp_path, value, only_in,
                                                 says):
    """A configuration's `reference` names a module in both folders."""
    root = make_tree(tmp_path, "float32")
    if only_in is not None:
        (root / "bench" / only_in / f"{value}.py").write_text("")
    path = root / "bench" / "configs" / "granite-tiny.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()),
                                    reference=value)))
    found = manifest.problems(json.loads((root / "BENCHMARK.json")
                                         .read_text()), root)
    assert found == [f"config granite-tiny: no {kind} module {value!r}"
                     for kind in says]


def test_a_cell_added_by_files_alone_runs(tmp_path):
    root = make_tree(tmp_path, "float32")
    man = Manifest(root)
    assert manifest.problems(man.data, root) == []
    out, run = run_cell(man, "tiny-dense.open", 7, 0.5, False, device="cpu",
                        t_start=time.perf_counter(), log=lambda m: None)
    assert out["correct"] and out["failed"] == 0
    assert set(out["metrics"]) == {"ttft_p95_ms", "itl_p50_ms", "itl_p99_ms",
                                   "setup_s"}
    assert list(out)[-1] == "checks"
    assert all(math.isfinite(v["value"]) for v in out["metrics"].values())
    out, run = run_cell(man, "tiny-moe.closed", 7, 0.5, True, device="cpu",
                        t_start=time.perf_counter(), log=lambda m: None)
    assert out["correct"]
    # per-layer metrics of the engine; no device numbers off the card
    assert "engine.step_ms.decode" in out["metrics"]
    assert not {"device.idle_share.decode", "model.mfu.decode",
                "decode_attention_roofline"} & set(out["metrics"])
    assert len(out["breakdown"]["idle_gaps"]) <= 10


def test_a_run_loads_no_jax_and_no_reference_package(tmp_path):
    root = make_tree(tmp_path, "float32")
    code = (f"import sys, time; sys.path[:0] = [{str(ROOT)!r}, "
            f"{str(ROOT / 'src')!r}]\n"
            "from bench.manifest import Manifest\n"
            "from bench.run import run_cell, forbidden_modules\n"
            f"run_cell(Manifest({str(root)!r}), 'tiny-dense.closed', 3, 0.3,"
            " True, device='cpu', t_start=time.perf_counter(),"
            " log=lambda m: None)\n"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], text=True,
                         capture_output=True, check=True).stdout
    assert out.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_x", sys)
    assert "repro" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert "repro" in forbidden_modules()


def test_without_a_card_a_run_exits_nonzero_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload",
         "granite-3-8b.docqa", "--seed", str(2**31 + 1), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, text=True, capture_output=True)
    assert proc.returncode != 0 and proc.stdout == ""


def test_without_the_program_a_run_exits_nonzero(tmp_path):
    import shutil
    shutil.copytree(ROOT / "bench", tmp_path / "bench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload",
         "granite-3-8b.docqa", "--seed", "1", "--seconds", "1"],
        cwd=tmp_path, text=True, capture_output=True)
    assert proc.returncode != 0 and proc.stdout == ""
