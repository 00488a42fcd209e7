"""A configuration file as the program under test takes it: the
`repro_torch.models.ModelConfig` that its family (`bench.families`)
builds from the file's published keys."""

from __future__ import annotations

from . import families


def model_config(c: dict):
    """`ModelConfig` for configuration file `c`; raises where the file
    asks for what the program cannot run."""
    return families.module(c).model_config(c)
