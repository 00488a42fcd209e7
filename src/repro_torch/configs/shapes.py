"""Assigned input shapes per (arch, shape), the port's copy of the table in
`repro.configs.shapes`.

Shapes (one set, paired with every LM arch):
    train_4k     seq 4096,   global_batch 256   (training)
    prefill_32k  seq 32768,  global_batch 32    (inference prefill)
    decode_32k   seq 32768,  global_batch 128   (one token, 32k KV cache)
    long_500k    seq 524288, global_batch 1     (long-context decode)

`long_500k` needs sub-quadratic attention: it runs for ssm/hybrid archs and
for sliding-window archs (bounded ring cache), and is skipped for pure
full-attention archs. The reference's `input_specs` (stand-in structs and
partition specs for its dry run) comes with `launch.dryrun` (ROADMAP Queue
1, item 18c).
"""

from __future__ import annotations

import dataclasses

from ..models import ModelConfig


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
