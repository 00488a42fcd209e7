"""The port-built sliding-window shipped graphs against the reference's, and their
golden cases planned by both planners (see tests/test_torch_workloads.py)."""

import pytest

from test_torch_workloads import (SWA_GRAPHS, cases_of, check_case,
                                  check_graph)


@pytest.mark.parametrize("name", SWA_GRAPHS)
def test_graph_equals_the_reference_graph(name):
    check_graph(name)


@pytest.mark.parametrize("case", cases_of(SWA_GRAPHS))
def test_plan_on_the_port_graph_equals_the_reference(case):
    check_case(case)
