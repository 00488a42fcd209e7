"""Move a reference parameter tree, held as numpy arrays, into the port.

The reference draws its weights with `jax.random`; parity tests hand the
same weights to both packages by converting the JAX tree with
`jax.tree.map(np.asarray, params)` and passing it here. bf16 arrives as
`ml_dtypes.bfloat16`, which `torch.from_numpy` rejects, so it crosses as
its uint16 bits and is viewed back as `torch.bfloat16`: bits round-trip
exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def tensor_from_numpy(arr, device=None) -> torch.Tensor:
    """One array -> tensor on `device` (None: the card), bits unchanged."""
    arr = np.array(arr)                 # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(resolve_device(device))


def params_from_numpy(tree, device=None):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)
