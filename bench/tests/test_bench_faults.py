"""A run with its timed path broken underneath sees `correct` come out
false: a decode step that leaves the cache unchanged, half of the batch
left out, a token altered where it is produced (`bench.faults`). The
look for a chip is skipped (CPU sizes, the program's plain path); the
rest of the run is the benchmark's own. The deep cells are bf16 and
held to the committed cells' own limits."""

import time

import pytest
import torch

from bench.faults import FAULTS
from bench.manifest import Manifest
from bench.run import run_cell
from bench.tests.tiny import DEEP_S, STANDS_FOR, make_tree


@pytest.fixture(scope="module", params=["logit_gap", "share_over_1"])
def tree(request, tmp_path_factory):
    """The tiny cells, the MoE cell held by the widest gap or by the share
    of gaps over 1 (the qwen cell's number)."""
    return Manifest(make_tree(tmp_path_factory.mktemp("faults"), "float32",
                              limit=0.05, moe_number=request.param))


def _run(man, cell, seconds=0.6):
    out, _ = run_cell(man, cell, 11, seconds, False, device="cpu",
                      t_start=time.perf_counter(), log=lambda m: None)
    return out


@pytest.mark.parametrize("cell", ["tiny-dense.closed", "tiny-dense.open",
                                  "tiny-moe.closed"])
def test_sound_runs_are_correct(tree, cell):
    assert _run(tree, cell)["correct"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["tiny-dense.closed", "tiny-moe.closed"])
def test_a_fault_makes_the_run_incorrect(tree, cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch.setattr)
    with torch.no_grad():
        out = _run(tree, cell)
    assert not out["correct"], out["checks"]


@pytest.fixture(scope="module")
def deep(tmp_path_factory):
    return Manifest(make_tree(tmp_path_factory.mktemp("deep"), "bfloat16"))


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(STANDS_FOR))
def test_a_fault_fails_the_committed_limits(deep, cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch.setattr)
    with torch.no_grad():
        out = _run(deep, cell, DEEP_S)
    assert not out["correct"], out["checks"]
