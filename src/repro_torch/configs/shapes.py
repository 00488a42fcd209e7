"""Assigned input shapes per (arch, shape), the port's copy of the table in
`repro.configs.shapes`.

Shapes (one set, paired with every LM arch):
    train_4k     seq 4096,   global_batch 256   (training)
    prefill_32k  seq 32768,  global_batch 32    (inference prefill)
    decode_32k   seq 32768,  global_batch 128   (one token, 32k KV cache)
    long_500k    seq 524288, global_batch 1     (long-context decode)

`long_500k` needs sub-quadratic attention: it runs for ssm/hybrid archs and
for sliding-window archs (bounded ring cache), and is skipped for pure
full-attention archs. `input_specs` and `cache_specs` give a cell's
stand-ins (`meta` tensors: shapes and dtypes, no storage) and their
partition specs, the inputs of `launch.dryrun`.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models import ModelConfig, torch_dtype
from ..models.cache import cache_defs, leaf_dtype
from ..models.sharding import Shardings, tree_map, tree_specs


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def long_context_capable(cfg: ModelConfig) -> bool:
    """Sub-quadratic context: SSM/hybrid state or a sliding window."""
    return cfg.family in ("ssm", "hybrid") or cfg.sliding_window > 0


def skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not long_context_capable(cfg):
        return "pure full-attention arch: 500k dense KV is quadratic-cost"
    return None


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                shd: Shardings | None = None) -> tuple[dict, dict]:
    """(meta-tensor stand-ins, PartitionSpecs) of one cell's inputs.

    Stub frontends: [vlm]/[audio] get precomputed patch/frame embeddings
    instead of raw pixels/audio. Batch-sharded where the batch divides
    the axes; `mrope_positions` (3, B, S) stays replicated. Without `shd`
    every spec is None."""
    b, s = shape.global_batch, shape.seq_len
    tok = lambda shp: torch.empty(shp, dtype=torch.int32, device="meta")
    emb = lambda shp: torch.empty(shp, dtype=torch_dtype(cfg.dtype),
                                  device="meta")

    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        if cfg.input_mode == "embeds":          # vlm backbone stub
            specs["embeds"] = emb((b, s, cfg.d_model))
            if cfg.rope == "mrope":
                specs["mrope_positions"] = tok((3, b, s))
        else:
            specs["tokens"] = tok((b, s))
        if shape.kind == "train":
            specs["labels"] = tok((b, s))
        if cfg.encoder_layers:                  # audio backbone stub
            specs["encoder_embeds"] = emb((b, cfg.encoder_seq, cfg.d_model))
    else:  # decode: one new token against a seq_len-deep cache
        specs["tokens"] = tok((b, 1))

    def shard_of(name: str, st):
        if shd is None or name == "mrope_positions":
            return None
        return shd.batch_spec(st.shape)
    return specs, {k: shard_of(k, v) for k, v in specs.items()}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                shd: Shardings | None = None):
    """(meta-tensor stand-ins, PartitionSpecs or None) of the decode /
    prefill cache, each leaf in `models.cache.leaf_dtype`."""
    defs = cache_defs(cfg, shape.global_batch, shape.seq_len)
    structs = tree_map(lambda d: torch.empty(
        d.shape, dtype=leaf_dtype(cfg, d), device="meta"), defs)
    specs = tree_specs(shd, defs) if shd is not None else None
    return structs, specs


def tokens_in(shape: ShapeConfig) -> int:
    if shape.kind == "train" or shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch  # decode: one token per sequence
