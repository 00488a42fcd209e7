"""repro_torch.models — the model zoo in PyTorch: attention decoders (dense
or MoE MLP), the jamba hybrid, RWKV-6, whisper and qwen2-vl."""

from .cache import cache_defs, cache_width, init_cache
from .config import LayerSpec, ModelConfig, torch_dtype
from .sharding import (DECODE_POLICY, TRAIN_POLICY, AbstractMesh,
                       PartitionSpec, ParamDef, Policy, Shardings, is_def,
                       placements, stack_defs, tree_map, tree_shape_structs,
                       tree_specs)
from .transformer import (forward, init_params, init_tree, lm_loss,
                          param_defs, param_shape_structs, param_specs,
                          quantize_moe_params)
