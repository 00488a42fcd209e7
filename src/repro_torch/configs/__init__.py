"""Assigned architectures (10). `--arch <id>` selects one.

The same tables as `repro.configs`: `ARCHS` at published widths and
`REDUCED` for tests. `shapes` holds the input-shape table (`ShapeConfig`,
`SHAPES`) and the dry run's stand-ins (`input_specs`, `cache_specs`)."""

from . import (deepseek_coder_33b, granite_3_8b, jamba_15_large,
               llama3_405b, mixtral_8x7b, qwen2_moe_a27b, qwen2_vl_72b,
               rwkv6_3b, starcoder2_7b, whisper_tiny)

_MODULES = [qwen2_vl_72b, mixtral_8x7b, qwen2_moe_a27b, jamba_15_large,
            rwkv6_3b, deepseek_coder_33b, starcoder2_7b, granite_3_8b,
            llama3_405b, whisper_tiny]

ARCHS = {m.CONFIG.name: m.CONFIG for m in _MODULES}
REDUCED = {m.CONFIG.name: m.REDUCED for m in _MODULES}


def get_arch(name: str, reduced: bool = False):
    table = REDUCED if reduced else ARCHS
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]
