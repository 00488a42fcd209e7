"""The port's planner against the reference planner on the longest golden
case: the 32k-token banded prefill DAG of a 4096 window under the
overlapped objective (branch-and-bound over 517 nodes; see
tests/test_torch_planner.py)."""

from test_torch_planner import LONG_CASE, check_case


def test_plan_equals_the_reference_planner():
    check_case(LONG_CASE)
