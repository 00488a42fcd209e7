"""The port's config tables are field-for-field copies of the reference's."""

import dataclasses

import pytest
import torch

from repro.configs import ARCHS, REDUCED
from repro_torch.configs import ARCHS as T_ARCHS
from repro_torch.configs import REDUCED as T_REDUCED
from repro_torch.configs import get_arch
from repro_torch.models import torch_dtype

TABLES = {"ARCHS": (ARCHS, T_ARCHS), "REDUCED": (REDUCED, T_REDUCED)}


@pytest.mark.parametrize("table,name",
                         [(t, n) for t in TABLES for n in sorted(ARCHS)])
def test_config_matches_reference(table, name):
    ref, port = TABLES[table][0][name], TABLES[table][1][name]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.padded_vocab, port.hd, port.n_blocks) == \
        (ref.padded_vocab, ref.hd, ref.n_blocks)
    assert ([dataclasses.astuple(s) for s in port.layer_pattern()]
            == [dataclasses.astuple(s) for s in ref.layer_pattern()])
    assert port.param_count() == ref.param_count()
    assert port.param_count(active_only=True) == \
        ref.param_count(active_only=True)


def test_tables_have_the_same_archs():
    assert sorted(T_ARCHS) == sorted(ARCHS)
    assert sorted(T_REDUCED) == sorted(REDUCED)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_torch_dtype():
    assert torch_dtype("bfloat16") is torch.bfloat16
    assert torch_dtype("float32") is torch.float32
    with pytest.raises(ValueError):
        torch_dtype("complex64")
