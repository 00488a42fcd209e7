"""The port's gateway against the reference gateway: the stall budget at
its two extremes, prewarm, and the dispatch engine under the gateway.
The cases and the comparison are tests/test_torch_gateway_parity.py's."""

import pytest

from test_torch_gateway_parity import check_f32


@pytest.mark.parametrize("name", ["stall-0", "stall-1e9", "prewarm",
                                  "dispatch"])
def test_f32_decisions_and_tokens_equal_the_reference(name):
    check_f32(name)
