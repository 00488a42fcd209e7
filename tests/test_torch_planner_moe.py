"""The port's planner against the reference planner on the MoE, int8,
expert-parallel and cross-step graphs of the golden cases (see
tests/test_torch_planner.py)."""

import pytest

from test_torch_planner import MOE_GRAPHS, cases_of, check_case


@pytest.mark.parametrize("case", cases_of(MOE_GRAPHS))
def test_plan_equals_the_reference_planner(case):
    check_case(case)
