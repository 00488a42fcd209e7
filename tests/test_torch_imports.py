"""The port stands alone: neither `repro_torch` nor chip_smoke.py,
serve_pair.py, mesh_pair.py, ring_sweep.py and flash_bwd_sweep.py import
JAX or anything of the reference package, and its entry points default
to the card instead of falling back to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
SCRIPTS = ("chip_smoke", "serve_pair", "mesh_pair", "ring_sweep",
           "flash_bwd_sweep")
FILES = sorted(PORT.rglob("*.py")) + [ROOT / f"{s}.py" for s in SCRIPTS]


def test_importing_the_port_loads_no_jax():
    modules = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
               for p in sorted(PORT.rglob("*.py"))]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            f"import {', '.join(SCRIPTS)}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules)); assert not bad, bad\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized(), 'an import started a group'\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_reference_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch import bridge, prim
    from repro_torch.benchmarks import (dispatch_bench, gateway_bench,
                                        prim_bench, suitability_bench)
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.examples import (dispatch_demo, gateway_serve,
                                      prim_multibank, quickstart,
                                      serve_decode)
    from repro_torch.configs import REDUCED
    from repro_torch.core.bank_parallel import BankGrid
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.examples import train_lm
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.train import (HParams, LoopConfig, TrainLoop,
                                   make_batch)
    from repro_torch.models import init_cache, init_params
    from repro_torch.dispatch import workloads
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.dispatch_engine import (DispatchDecodeStep,
                                                   DispatchPrefillStep)
    cfg = REDUCED["granite-3-8b"]
    params = init_params(0, cfg, device="cpu")
    for call in (lambda: ServeEngine(cfg, params, batch_slots=1, max_len=8),
                 lambda: init_params(0, cfg),
                 lambda: init_cache(cfg, 1, 8),
                 lambda: bridge.params_from_numpy({"a": [1.0]}),
                 lambda: serve.main(["--arch", "granite-3-8b", "--reduced"]),
                 lambda: BankGrid(8),
                 lambda: prim.make_inputs("VA", 8, torch.Generator()),
                 lambda: prim_bench.run(bench_run.Report()),
                 lambda: bench_run.main(["prim_bench"]),
                 lambda: suitability_bench.run(bench_run.Report()),
                 lambda: suitability_bench.prim_reports(),
                 lambda: bench_run.main(["suitability_bench"]),
                 lambda: serve.main(["--arch", "granite-3-8b", "--reduced",
                                     "--engine", "dispatch"]),
                 lambda: DispatchDecodeStep(cfg, batch_slots=1, max_len=8),
                 lambda: DispatchPrefillStep(cfg, max_len=8),
                 lambda: workloads.mixed_pipeline(m=8),
                 lambda: workloads.decode_pipeline(),
                 lambda: bench_run.main(["scaling_bench"]),
                 lambda: bench_run.main(["dispatch_bench", "--quick"]),
                 lambda: bench_run.main(["gateway_bench", "--quick"]),
                 lambda: dispatch_bench.run(bench_run.Report(), quick=True),
                 lambda: gateway_bench.run(bench_run.Report(), quick=True),
                 lambda: quickstart.main([]),
                 lambda: prim_multibank.main([]),
                 lambda: dispatch_demo.main([]),
                 lambda: serve_decode.main([]),
                 lambda: gateway_serve.main([]),
                 lambda: TrainLoop(cfg, ShapeConfig("t", 8, 1, "train"),
                                   HParams(), LoopConfig()),
                 lambda: make_batch(cfg, ShapeConfig("t", 8, 1, "train"), 0),
                 lambda: launch_train.main(["--arch", "granite-3-8b",
                                            "--reduced"]),
                 lambda: launch_train.main(["--arch", "granite-3-8b",
                                            "--reduced", "--mesh"]),
                 lambda: make_smoke_mesh(),
                 lambda: train_lm.main([])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_launcher_serves_through_dispatch_on_the_cpu(capsys):
    """`launch.serve --engine dispatch --device cpu` serves a REDUCED
    config through the planner-routed steps."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.examples import train_lm
    from repro_torch.launch import serve
    from repro_torch.launch import train as launch_train
    from repro_torch.train import (HParams, LoopConfig, TrainLoop,
                                   make_batch)
    assert serve.main(["--arch", "granite-3-8b", "--reduced", "--device",
                       "cpu", "--engine", "dispatch", "--prefill-chunk",
                       "4", "--requests", "3", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert "decode plan: dag-dp" in out and "prefill plan:" in out
    assert "3 requests" in out
