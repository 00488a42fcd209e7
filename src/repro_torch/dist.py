"""DTensor helpers that both the kernels' wrappers and the model use,
with no dependency on either: whether a tensor is a DTensor, the extent
of one rank's shard, and placements whose uneven shards are turned into
replicas."""

from __future__ import annotations

import functools


@functools.cache
def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor_type())


def local_extent(shape, mesh, plc) -> tuple[list[int], list[int]]:
    """(local shape, global offset) of this rank's shard of a tensor of
    global `shape` laid out by placements `plc` on `mesh`, by
    `torch.chunk`'s rule (chunks of ceil(n / parts), the last ones short
    or empty), mesh dims applied in order. Plain integer arithmetic (no
    tensor op), so it runs under a fake mode."""
    shape, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    for i, p in enumerate(plc):
        if not p.is_shard():
            continue
        d, n = p.dim, mesh.size(i)
        step = -(-shape[d] // n)
        start = min(coord[i] * step, shape[d])
        offset[d] += start
        shape[d] = max(min(step, shape[d] - start), 0)
    return shape, offset


def replicate_uneven(plc, shape, mesh, dims=None) -> tuple:
    """`plc` with every `Shard(d)` whose mesh dim's size does not divide
    `shape[d]` turned into `Replicate()` (only for d in `dims`, if given):
    DTensor cannot split or merge an uneven shard, and `local_map`
    rebuilds its outputs as even ones."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() if p.is_shard()
                 and (dims is None or p.dim in dims)
                 and shape[p.dim] % mesh.size(i) else p
                 for i, p in enumerate(plc))
