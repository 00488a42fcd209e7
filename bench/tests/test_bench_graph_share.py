"""`engine.graph_share.decode` in a run of a tiny closed cell on the CPU,
where every step is eager, and on the same run's step events flagged as
replayed or carrying no flag, as a program older than the flag's."""

import time

import pytest

from bench.manifest import Manifest
from bench.run import run_cell
from bench.tests.tiny import make_tree

METRIC = "engine.graph_share.decode"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    man = Manifest(make_tree(tmp_path_factory.mktemp("graph"), "float32"))
    mix = {"output_tokens": {"dist": "uniform", "lo": 40, "hi": 90}}
    _, run = run_cell(man, "tiny-dense.closed", 2**31 + 7, 1.0, False,
                      device="cpu", t_start=time.perf_counter(),
                      log=lambda m: None, mix=mix)
    return man.reader(METRIC), run


@pytest.mark.parametrize("flag,share", [(None, 0.0), (True, 100.0),
                                        ("missing", None)])
def test_share_of_replayed_steps(served, monkeypatch, flag, share):
    read, run = served
    from repro_torch.serve.engine import RECENT
    steps = [e for e in RECENT.events if e.kind == "decode_step"]
    assert steps and all(e.attrs["graphed"] is False for e in steps)
    for e in steps:
        if flag == "missing":
            monkeypatch.delitem(e.attrs, "graphed")
        elif flag is not None:
            monkeypatch.setitem(e.attrs, "graphed", flag)
    assert read(run) == share
