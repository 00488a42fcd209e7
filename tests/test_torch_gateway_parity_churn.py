"""The port's gateway against the reference gateway: the plan-cache churn
run, and the default bf16 model (decisions only). The cases and the
comparison are tests/test_torch_gateway_parity.py's."""

import pytest

from test_torch_gateway_parity import check_bf16, check_f32


@pytest.mark.parametrize("name", ["churn"])
def test_f32_decisions_and_tokens_equal_the_reference(name):
    check_f32(name)


@pytest.mark.parametrize("name", ["capacity", "churn"])
def test_bf16_decisions_equal_the_reference(name):
    check_bf16(name)
