"""The port-built 32k-token banded prefill DAG (a 4096 window, 8192-token
chunks) against the reference's, and its two golden cases planned by
both planners: branch-and-bound over 517 nodes (see
tests/test_torch_workloads.py)."""

import pytest

from test_torch_workloads import LONG_GRAPH, cases_of, check_case, check_graph


def test_graph_equals_the_reference_graph():
    check_graph(LONG_GRAPH)


@pytest.mark.parametrize("case", cases_of((LONG_GRAPH,)))
def test_plan_on_the_port_graph_equals_the_reference(case):
    check_case(case)
