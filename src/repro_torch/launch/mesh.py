"""Meshes, the counterpart of `repro.launch.mesh`. Functions, not module
constants: importing this module starts no process group.

Topology of the modelled pods (TPU v5e, as the reference):
  single-pod : (16, 16)    axes ("data", "model")   = 256 chips
  multi-pod  : (2, 16, 16) axes ("pod", "data", "model") = 512 chips

"model" is the innermost axis (fastest ring): tensor-parallel
collectives are the latency-critical ones. "pod" is outermost: only
data-parallel gradient all-reduces cross the inter-pod links.

`make_production_mesh` builds such a mesh over a fake process group (one
process stands for every rank; collectives do nothing) on device type
"cpu", for the dry run: DTensors on it hold fake tensors, so nothing
touches the card. `make_smoke_mesh` builds a real (1, n) mesh over the
devices of the running process group, starting a one-process group
where there is none.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import resolve_device


def _start_fake_group(world_size: int) -> None:
    """A fake process group of `world_size` ranks in this one process
    (rank 0). torch's `fake` backend lives in its private test utilities;
    this is the one place the port imports it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) or (2, 16, 16) production mesh over a fake process
    group of 256 or 512 ranks, started here (a fake group of the other
    size is replaced; a real group raises)."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if dist.is_initialized() and dist.get_backend() == "fake" and \
            dist.get_world_size() != n:
        dist.destroy_process_group()      # the other production mesh's
    if not dist.is_initialized():
        _start_fake_group(n)
    elif dist.get_backend() != "fake":
        raise RuntimeError(
            f"make_production_mesh needs a fake process group of {n} ranks; "
            f"this process has a {dist.get_backend()} group of "
            f"{dist.get_world_size()}")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_smoke_mesh(n: int | None = None, device=None):
    """A (1, n) ("data", "model") mesh over the ranks of the running process
    group (n: all of them). Where there is no group, a one-process group
    starts here with an in-memory store (no environment variables): NCCL
    on the card, gloo on the CPU. `device`: None (the card) or "cpu"."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    n = n or dist.get_world_size()
    return init_device_mesh(dev.type, (1, n), mesh_dim_names=("data",
                                                              "model"))
