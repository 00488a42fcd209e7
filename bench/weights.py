"""The served weights, drawn by the benchmark from `--seed` on the device.

One flat buffer in the served type is filled by one `normal_` call from a
`torch.Generator` on the device; each leaf is a view of it, in the order
and with the scale that the configuration's family lays out
(`bench.families`). The tree is the one the program's `ServeEngine`
takes: a path's string keys are dict keys and its integers list
positions. Both the program and the reference get these tensors.
"""

from __future__ import annotations

import math

import torch

from . import families

VOCAB_PAD = 128

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def layout(c: dict) -> list[tuple[tuple, tuple, str, float]]:
    """(path, shape, kind, std) of every leaf; kind is "w" (normal * std),
    "scale" (1 + std * normal) or "bias" (std * normal)."""
    return families.module(c).layout(c)


def _at(node, key, new):
    """node[key], made by `new()` where it is not there yet; an integer
    key is a list position, taken in order."""
    if isinstance(key, int):
        if key == len(node):
            node.append(new())
        return node[key]
    return node.setdefault(key, new())


def make(c: dict, seed: int, device) -> dict:
    """The weight tree of configuration `c` on `device`, from `seed`."""
    dtype = _DTYPES[c["torch_dtype"]]
    leaves = layout(c)
    total = sum(math.prod(shape) for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(generator=gen)
    tree: dict = {}
    at = 0
    for path, shape, kind, std in leaves:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        t.mul_(std)
        if kind == "scale":
            t.add_(1.0)
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            node = _at(node, key, list if isinstance(nxt, int) else dict)
        _at(node, path[-1], lambda: t)
    return tree


def nbytes(tree) -> int:
    """Bytes of the weight tree's leaves."""
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()
