"""The work the inputs need, from a configuration's shapes and the tokens
the driver sent and received: FLOPs and HBM bytes of a prefill, of a
decode step and of each kernel call, as the configuration's family
(`bench.families`) counts them. Each count is of what the inputs need,
not of what the program happens to do, and a lower bound of the work.
"""

from __future__ import annotations

from . import families

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def Counts(c: dict):  # noqa: N802 (named as the class it returns)
    """The counts of configuration file `c`, by its family's `Counts`
    (the interface `bench.families` states)."""
    return families.module(c).Counts(c)
