"""Model families, one module per kind of layer stack. A configuration
file's `reference` key names both its plain reference
(`bench/reference/<reference>.py`) and its family
(`bench/families/<reference>.py`): one name for one kind of stack.

A family module provides `model_config(c)`, the program's `ModelConfig`
of file `c` (raising where the program cannot run it); `layout(c)`, the
(path, shape, kind, std) of every weight leaf, with paths as in the
program's parameter tree, list positions as integers; and `Counts(c)`,
the work a prefill, a decode step and each attention call need
(`prefill_flops`, `decode_flops`, `prefill_bytes`, `decode_bytes`,
`flash_flops`, `flash_bytes`, `decode_attn_flops`, `decode_attn_bytes`,
`kv_bytes_per_token`, `weight_bytes`, `experts_touched`), with
`attn_layers`, the attention layers a step runs. A new kind of stack is
added as a new module here beside its reference; `bench.model`,
`bench.weights` and `bench.counts` dispatch to it by name.
"""

from __future__ import annotations

import importlib


def module(c: dict):
    """The family module of configuration file `c`."""
    return importlib.import_module(f"{__name__}.{c['reference']}")
