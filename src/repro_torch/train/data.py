"""Synthetic data pipeline, the counterpart of `repro.train.data`:
stateless, seeded, restart-exact.

A batch is a pure function of (seed, step): after a failure the pipeline
resumes from the checkpointed step with bit-identical batches, with no
loader state to snapshot. Tokens are Zipf-distributed (the reference's
inverse-CDF formula and clip), so the LM loss has structure to descend.
For the stub frontends the batch carries embeddings: `embeds` plus
`mrope_positions` for qwen2-vl, `encoder_embeds` for whisper.

The draws come from a CPU `torch.Generator` seeded from (seed, step), then
move to the device, so the CPU and the card see the same batches. They are
not `jax.random`'s bits; parity tests hand the reference's batch to both.
"""

from __future__ import annotations

import dataclasses

import torch

from ..configs.shapes import ShapeConfig
from ..device import resolve_device
from ..models import ModelConfig, torch_dtype
from ..models.sharding import P


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_exponent: float = 1.1


def _zipf_tokens(gen, shape, vocab: int, exponent: float) -> torch.Tensor:
    """Zipf-distributed int32 token ids by the inverse CDF of a uniform draw
    in [1e-6, 1): floor(u ** (-1 / (exponent - 1))), clipped to the vocab
    (in f32 before the cast, which saturates as XLA's conversion does)."""
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    u = torch.clamp(u * (1.0 - 1e-6) + 1e-6, min=1e-6)
    ids = torch.floor(torch.pow(u, -1.0 / (exponent - 1.0)))
    return torch.clamp(ids, 0, vocab - 1).to(torch.int32)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
               data_cfg: DataConfig = DataConfig(), device=None,
               shd=None) -> dict:
    """Batch for `step`, derived from (data_cfg.seed, step) alone, on
    `device` (None: the card). With `shd` on a mesh every field is a
    DTensor, batch-sharded (`Shardings.batch_spec`), `mrope_positions`
    replicated."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(
        (int(data_cfg.seed) << 32) + int(step))
    b, s = shape.global_batch, shape.seq_len
    dt = torch_dtype(cfg.dtype)
    zipf = lambda shp: _zipf_tokens(gen, shp, cfg.vocab_size,
                                    data_cfg.zipf_exponent)
    batch: dict = {}
    if cfg.input_mode == "embeds":
        batch["embeds"] = torch.randn((b, s, cfg.d_model), generator=gen,
                                      dtype=torch.float32).to(dt)
        if cfg.rope == "mrope":
            pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
            batch["mrope_positions"] = pos[None].expand(3, b, s).contiguous()
        batch["labels"] = zipf((b, s))
    else:
        toks = zipf((b, s + 1))
        batch["tokens"] = toks[:, :-1].contiguous()
        batch["labels"] = toks[:, 1:].contiguous()
    if cfg.encoder_layers:
        batch["encoder_embeds"] = torch.randn(
            (b, cfg.encoder_seq, cfg.d_model), generator=gen,
            dtype=torch.float32).to(dt)
    batch = {k: v.to(dev) for k, v in batch.items()}
    if shd is not None and shd.mesh is not None:
        batch = {k: shd.place(v, P() if k == "mrope_positions"
                              else shd.batch_spec(v.shape))
                 for k, v in batch.items()}
    return batch
