"""Parameter declarations: `ParamDef` (shape + logical kinds + initializer)
and the tree helpers over nested dicts and lists.

The port runs on one card without a mesh, so the logical `kinds` are kept
only to mirror `repro.models.sharding`; nothing reads them here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Shape + logical kinds + initializer for one parameter/state tensor."""
    shape: tuple[int, ...]
    kinds: tuple[str | None, ...]
    name: str = "?"
    init: str = "normal"        # normal | zeros | ones | small
    dtype: str | None = None    # None -> model dtype


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_map(fn: Callable[[Any], Any], tree, is_leaf=is_def):
    """Map `fn` over the leaves of nested dicts and lists. Dict keys are
    visited in sorted order, the order `jax.tree` flattens them in, so a
    stateful `fn` (a random generator) draws leaves in the reference's
    order."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, is_leaf) for t in tree)
    return fn(tree)


def stack_defs(defs, n: int):
    """Add a leading (blocks) dim of size n to every ParamDef."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, (None,) + d.kinds, d.name,
                           d.init, d.dtype), defs)
