"""The port's dry run against the reference's on a one-device mesh for the
seven archs tests/test_torch_dryrun.py leaves out: REDUCED qwen2-vl-72b,
qwen2-moe-a2.7b, jamba-1.5-large-398b, rwkv6-3b, deepseek-coder-33b,
starcoder2-7b and llama3-405b x decode, prefill and train at
`ShapeConfig("t", 64, 2, kind)`, through that file's `reference_cells`,
`port_cells` and checks: serving dot FLOPs equal exactly, each train
step's within the band of tests/test_torch_suitability.py's train row,
and the record's terms (`dominant`, resident bytes, model FLOPs and
bytes, dropped shardings) equal.
"""

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_dryrun import (KINDS, check_record_terms,  # noqa: E402
                               check_serving, check_train_band, port_cells,
                               reference_cells)

ARCHS = ("qwen2-vl-72b", "qwen2-moe-a2.7b", "jamba-1.5-large-398b",
         "rwkv6-3b", "deepseek-coder-33b", "starcoder2-7b", "llama3-405b")


@pytest.fixture(scope="module")
def both():
    """The port's cells traced in a second thread while the reference
    lowers its own (XLA's compiles release the interpreter)."""
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(port_cells, ARCHS)
        ref = reference_cells(ARCHS)
        return ref, port.result()


@pytest.fixture(scope="module")
def reference(both):
    return both[0]


@pytest.fixture(scope="module")
def port(both):
    return both[1]


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_dot_flops_equal_exactly(arch, kind, reference, port):
    check_serving(arch, kind, reference, port)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_dot_flops_within_the_suitability_band(arch, reference, port):
    check_train_band(arch, reference, port)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_record_terms_equal_the_reference(arch, kind, reference, port):
    check_record_terms(arch, kind, reference, port)
