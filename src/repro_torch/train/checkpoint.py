"""Checkpoints with an atomic manifest, the counterpart of
`repro.train.checkpoint`, in its on-disk format.

`<dir>/step_<N>/` holds one raw-bytes file per leaf (`leaf_<i>.bin`) and
`manifest.json` with the step, the leaf count, the tree's structure and
each leaf's dtype and shape. The manifest is written last, through a tmp
file and a rename, and the directory itself is renamed into place: a step
directory is valid iff its manifest exists, so a crash mid-write never
leaves a half-readable checkpoint (restore scans for the newest valid
step). Leaves are flattened in `jax.tree` order (dict keys sorted, lists
in order) and dtypes are named as numpy names them, so a checkpoint
written by either package restores in the other. bf16 crosses as its
uint16 bits (no `ml_dtypes` needed). A DTensor leaf is written whole
(`full_tensor()`), so the format does not know the mesh; `restore` places
each leaf onto the mesh and placements it is given (elastic restart onto
another mesh).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..models.sharding import full, is_dtensor, tree_map
from .optimizer import leaves

_NAMES = {torch.float32: "float32", torch.float64: "float64",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int32: "int32", torch.int64: "int64", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {n: d for d, n in _NAMES.items()}


def _leaf_bytes(t: torch.Tensor) -> bytes:
    t = full(t.detach()).to("cpu").contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _leaf_from_bytes(buf: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(buf, dtype=np.uint16).astype(np.int16, copy=True)
        return torch.from_numpy(arr).view(torch.bfloat16).reshape(shape)
    if dtype not in _DTYPES:
        raise ValueError(f"checkpoint leaf dtype {dtype!r} is not one of "
                         f"{sorted(_DTYPES)}")
    arr = np.frombuffer(buf, dtype=np.dtype(dtype)).copy()
    return torch.from_numpy(arr).reshape(shape)


def _structure(tree) -> str:
    return str(tree_map(lambda _: "*", tree, is_leaf=torch.is_tensor))


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or the
    only process."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, tree) -> str:
    """Atomically save `tree` under ckpt_dir/step_<step>. DTensor leaves
    are gathered leaf by leaf on every rank (a collective) and rank 0
    writes; the ranks then meet at a barrier, so none reads an unfinished
    step."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    sharded = any(is_dtensor(t) for t in leaves(tree))
    write = _writer()
    if write:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)

    meta = []
    for i, leaf in enumerate(leaves(tree)):
        blob = _leaf_bytes(leaf)
        if write:
            with open(os.path.join(tmp, f"leaf_{i}.bin"), "wb") as f:
                f.write(blob)
        meta.append({"dtype": _NAMES[leaf.dtype], "shape": list(leaf.shape)})

    if write:
        manifest = {"step": step, "n_leaves": len(meta),
                    "treedef": _structure(tree), "leaves": meta}
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath + ".w", "w") as f:
            json.dump(manifest, f)
        os.replace(mpath + ".w", mpath)      # manifest atomic within tmp
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)               # directory atomic rename
    if sharded:
        import torch.distributed as dist
        dist.barrier()
    return final


def valid_steps(ckpt_dir: str) -> list[int]:
    """Steps with a complete (manifest-bearing) checkpoint, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if not name.startswith("step_") or name.endswith(".tmp"):
            continue
        if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            try:
                out.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return sorted(out)


def latest_step(ckpt_dir: str) -> int | None:
    steps = valid_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, like_tree, shardings=None):
    """Restore into the structure of `like_tree`: leaf count and shapes are
    checked, dtypes are the checkpoint's, and each leaf lands on the
    device of its counterpart in `like_tree`. `shardings`: an optional
    tree like `like_tree` of `(mesh, placements)` or None (as
    `Shardings.named` gives them): such a leaf becomes a DTensor of them
    (resume onto any mesh). Without it, a DTensor leaf of `like_tree` is
    restored onto its own mesh and placements."""
    d = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    like = leaves(like_tree)
    if manifest["n_leaves"] != len(like):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(like)} — architecture/optimizer mismatch")
    targets = ([None] * len(like) if shardings is None else
               _named_leaves(shardings))
    out = []
    for i, (want, meta, tgt) in enumerate(zip(like, manifest["leaves"],
                                              targets)):
        with open(os.path.join(d, f"leaf_{i}.bin"), "rb") as f:
            t = _leaf_from_bytes(f.read(), meta["dtype"], meta["shape"])
        if tuple(t.shape) != tuple(want.shape):
            raise ValueError(f"leaf {i}: shape {tuple(t.shape)} != "
                             f"{tuple(want.shape)}")
        if tgt is None and is_dtensor(want):
            tgt = (want.device_mesh, tuple(want.placements))
        t = t.to(want.device)
        if tgt is not None:
            from torch.distributed.tensor import distribute_tensor
            t = distribute_tensor(t, tgt[0], tgt[1], src_data_rank=None)
        out.append(t)
    it = iter(out)
    return tree_map(lambda _: next(it), like_tree, is_leaf=torch.is_tensor)


def _named_leaves(shardings) -> list:
    """The `(mesh, placements)` pairs (or None) of a shardings tree, in
    leaf order."""
    out = []
    tree_map(out.append, shardings,
             is_leaf=lambda x: x is None or isinstance(x, tuple))
    return out


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest `keep` valid checkpoints."""
    steps = valid_steps(ckpt_dir)
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)
