"""tests/test_torch_train_parity.py's loss, gradient and AdamW parity for
the other half of the REDUCED archs (one file each, so that each finishes
in about a minute on one worker)."""

import pytest

from test_torch_train_parity import (HERE, NAMES, check_adamw,
                                     check_loss_and_gradients)


@pytest.mark.parametrize("name", [n for n in NAMES if n not in HERE])
def test_loss_and_gradients_match_reference(name):
    check_loss_and_gradients(name)


@pytest.mark.parametrize("name", [n for n in NAMES if n not in HERE])
def test_three_adamw_updates_match_reference(name):
    check_adamw(name)
