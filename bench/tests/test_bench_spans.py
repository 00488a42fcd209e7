"""The per-layer metrics that read the engine's step record and spans
(`repro_torch.serve.engine.RECENT`) in traced runs of the tiny cells on
the CPU, and what they report where the program has no such record."""

import math
import time

import pytest

from bench.manifest import Manifest
from bench.run import run_cell
from bench.tests.tiny import make_tree

DECODE = ("engine.launch_ms.decode", "engine.sync_ms.decode")
PREFILL = ("engine.prefill_launch_ms.docqa", "engine.prefill_sync_ms.docqa")


@pytest.fixture(scope="module")
def man(tmp_path_factory):
    return Manifest(make_tree(tmp_path_factory.mktemp("spans"), "float32"))


def _traced(man, cell):
    """A traced run of some hundreds of engine calls whose slice holds one
    or two, so that the window's readers, which leave the slice out, and
    the counters, which do not, read nearly the same calls."""
    mix = {"trace": {"start_s": 0.3, "length_s": 0.005}}
    if cell.endswith("closed"):
        # outputs long enough that the clients' pool lasts the window
        mix["output_tokens"] = {"dist": "uniform", "lo": 40, "hi": 90}
    return run_cell(man, cell, 2**31 + 5, 1.5, True, device="cpu",
                    t_start=time.perf_counter(), log=lambda m: None,
                    mix=mix)


@pytest.mark.parametrize("cell", ["tiny-dense.closed", "tiny-moe.closed"])
def test_decode_split_within_the_step(man, cell):
    out, run = _traced(man, cell)
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert all(math.isfinite(got[k]) and got[k] > 0 for k in DECODE)
    assert got[DECODE[0]] + got[DECODE[1]] \
        <= 1.01 * got["engine.step_ms.decode"]
    if cell == "tiny-moe.closed":
        # listed in the qwen cell alone, so read here by hand
        share = man.reader("model.moe_share.decode")(run)
        assert 0 < share <= 100


def test_prefill_split(man):
    out, _ = _traced(man, "tiny-dense.open")
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert all(math.isfinite(got[k]) and got[k] > 0 for k in PREFILL)
    assert got[PREFILL[0]] + got[PREFILL[1]] \
        <= 1.01 * got["engine.prefill_ms.docqa"]


def test_a_program_without_the_record_reports_nothing(man, monkeypatch):
    """A program that lacks the step record, as one older than these
    metrics does, leaves the five metrics out and raises nothing."""
    _, run = _traced(man, "tiny-moe.closed")
    import repro_torch.serve.engine as engine
    monkeypatch.delattr(engine, "RECENT")
    for name in DECODE + PREFILL + ("model.moe_share.decode",):
        assert man.reader(name)(run) is None
