"""The port's planner against the reference planner on the
sliding-window graphs of the golden cases, but for the longest (see
tests/test_torch_planner.py and tests/test_torch_planner_swa32k.py)."""

import pytest

from test_torch_planner import SWA_GRAPHS, cases_of, check_case


@pytest.mark.parametrize("case", cases_of(SWA_GRAPHS))
def test_plan_equals_the_reference_planner(case):
    check_case(case)
