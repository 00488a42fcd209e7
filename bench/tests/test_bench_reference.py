"""The plain reference against the port on tiny configurations on the
CPU, the comparison's control at a size a test run can hold, and the
reference's independence from the program."""

import ast
import json
import subprocess
import sys
import time

import pytest
import torch

from bench import weights
from bench.manifest import Manifest
from bench.reference import decoder
from bench.run import run_cell
from bench.tests.tiny import (BENCH, DEEP_S, DENSE, MOE, ROOT, STANDS_FOR,
                               make_tree)


def _port_logits(c, tree, tokens):
    from repro_torch.models import forward

    from bench.model import model_config
    with torch.no_grad():
        logits, _, _ = forward(tree, model_config(c), tokens=tokens[None])
    return logits[0, :, :c["vocab_size"]].float()


@pytest.mark.parametrize("c", [DENSE, MOE], ids=["dense", "moe"])
def test_reference_matches_the_port_in_float32(c):
    tree = weights.make(c, 3, "cpu")
    tokens = torch.randint(0, c["vocab_size"], (96,),
                           generator=torch.Generator().manual_seed(1))
    want = _port_logits(c, tree, tokens)
    got = decoder.logits_at(c, tree, [tokens], [96], [0])[0]
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale


def test_capacity_drops_are_part_of_the_reference():
    # 96 tokens, 6 experts, top-2: 40 places an expert, 32 tokens each on
    # average; some expert overflows, and the port drops as the file says
    tree = weights.make(MOE, 3, "cpu")
    tokens = torch.randint(0, MOE["vocab_size"], (96,),
                           generator=torch.Generator().manual_seed(1))
    dropped = decoder.logits_at(MOE, tree, [tokens], [96], [0])[0]
    kept = decoder.logits_at(MOE, tree, [tokens], [0], [0])[0]
    assert (dropped - kept).abs().max() > 1e-3
    assert (dropped - _port_logits(MOE, tree, tokens)).abs().max() < 1e-3


def test_full_precision_turns_tf32_off_and_back():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with decoder.full_precision():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_fp8_control_rounds_every_product():
    tree = weights.make(DENSE, 4, "cpu")
    tokens = torch.arange(40)
    f32 = decoder.logits_at(DENSE, tree, [tokens], [40], [0])[0]
    fp8 = decoder.logits_at(DENSE, tree, [tokens], [40], [0], "fp8")[0]
    assert 1e-2 < (fp8 - f32).abs().max() / f32.abs().max() < 0.5


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    return Manifest(make_tree(tmp_path_factory.mktemp("control"), "bfloat16"))


@pytest.mark.parametrize("cell", sorted(STANDS_FOR))
def test_control_fails_where_the_program_passes(deep, cell):
    """At a size a test run holds, bf16 serving is correct and the
    reference in float8 in its place is not, both judged by the run's own
    verdict under the limits of the committed cell the tiny cell stands
    for, on three seeds."""
    committed = json.loads((BENCH / "workloads" /
                            f"{STANDS_FOR[cell]}.json").read_text())["check"]
    for seed in (0, 1, 2):
        out, _ = run_cell(deep, cell, seed, DEEP_S, False, device="cpu",
                          t_start=time.perf_counter(), control=True,
                          log=lambda m: None)
        assert {k: v["limit"] for k, v in out["checks"].items()} == \
            committed["limit"]
        assert out["correct"], out["checks"]
        assert out["control"]["correct"] is False, out["control"]["numbers"]


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] in {"torch", "math", "contextlib",
                                              "__future__"}, (path, name)
    code = ("import sys; import bench.reference.decoder; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, check=True).stdout
    top = set(json.loads(out.replace("'", '"')))
    assert not top & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
