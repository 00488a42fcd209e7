"""repro_torch.models — attention decoders (dense or MoE MLP) in PyTorch."""

from .cache import cache_defs, cache_width, init_cache
from .config import LayerSpec, ModelConfig, torch_dtype
from .sharding import ParamDef, is_def, stack_defs, tree_map
from .transformer import (forward, init_params, param_defs,
                          quantize_moe_params)
