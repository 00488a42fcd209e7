"""Logical-axis sharding: one table maps model dims onto mesh axes, the
counterpart of `repro.models.sharding` on PyTorch's own SPMD (a
`DeviceMesh` and DTensor placements).

Production mesh axes (`launch.mesh`): ("pod",) "data", "model".

Train policy (2-D FSDP x TP, MaxText-style):
  * batch            -> ("pod", "data")
  * weight in-dim    -> "data"   (FSDP: all-gathered per layer)
  * weight out-dim / heads / ffn / vocab -> "model" (tensor parallel)
  * KV-cache seq     -> "model"  (flash-decoding / bank-parallel layout)

Decode reuses the same weight layout, so a checkpoint loads without a
reshard.

Divisibility: a dim is only sharded if the axis size divides it; otherwise
the rule is dropped for that tensor and recorded in `Shardings.dropped`,
with the reference's message, in the reference's order. Under
`pad_uneven_heads` the rule is kept where the size does not divide: GSPMD
pads such a dim, DTensor shards it unevenly (`torch.chunk`: the leading
shards one longer, trailing ones shorter or empty).

A spec is the port's own `PartitionSpec`: a tuple of None, an axis name or
a tuple of names, trailing Nones stripped. `placements(spec, mesh)` turns
it into DTensor placements: a tensor dim over ("pod", "data") is `Shard`
on both mesh dims, pod-major, the order GSPMD splits it in.

`Shardings.act` is the reference's activation constraint: a no-op without
a mesh or on a plain tensor, else a `redistribute` of the DTensor to the
spec's placements. GSPMD also propagates each constraint back into the
product that feeds it; DTensor picks a product's layout from its operands
alone, so `Shardings.lay` gives each product's operands the layout GSPMD
derives before the product runs (activations keep batch on "data", a
weight's FSDP dim is gathered and its TP dim stays; where the batch does
not divide "data", `Shardings.stationary`, the contraction runs over the
FSDP shard instead). `Shardings.local_with` (and `local`, its row-only
form) runs work that is local along its sharded dims (the MoE scatter,
the embedding gather, the recurrent scans) on each device's shards
through `local_map`: DTensor refuses in-place updates that would change
a placement and lacks rules for some of these ops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable

import torch

from ..dist import is_dtensor


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), an axis name, or a
    tuple of axis names (the dim split over all of them, first the
    outermost). Trailing Nones are not stored."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names without devices or a process group:
    enough for `Shardings.spec` (the counterpart of
    `jax.sharding.AbstractMesh`)."""
    shape: tuple[int, ...]
    mesh_dim_names: tuple[str, ...]

    def size(self) -> int:
        return math.prod(self.shape)


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a `DeviceMesh` or an `AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class Policy:
    batch: tuple[str, ...] = ("pod", "data")
    fsdp: tuple[str, ...] = ("data",)
    tp: tuple[str, ...] = ("model",)
    # KV cache layout: "sequence" (flash-decoding) | "heads" | "batch"
    kv_layout: str = "sequence"
    # shard vocab dim of embedding / lm head over tp
    shard_vocab: bool = True
    # keep a tp rule where heads don't divide the tp axis (GSPMD pads,
    # DTensor shards unevenly)
    pad_uneven_heads: bool = False
    # sequence-parallel activations between layers (Megatron SP)
    seq_parallel_acts: bool = True
    # experts dim over tp instead of per-expert ffn TP
    expert_parallel: bool = False


TRAIN_POLICY = Policy()
DECODE_POLICY = Policy(kv_layout="sequence", seq_parallel_acts=False)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`: for each mesh dim, `Shard(d)`
    where tensor dim d's entry names that axis, else `Replicate()`. A
    tensor dim over several axes must name them in mesh order (pod-major
    over ("pod", "data")), which is the order DTensor shards in."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in mesh order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


class Shardings:
    """Resolves logical dims against a mesh; a None mesh is a no-op (one
    device, every test that predates the mesh)."""

    def __init__(self, mesh=None, policy: Policy = TRAIN_POLICY):
        self.mesh = mesh
        self.policy = policy
        self.dropped: list[str] = []
        # the activation constraints' dropped rules, each once in the
        # order first met (`act` runs every layer of every step)
        self.act_dropped: dict[str, None] = {}
        self._axis_size = mesh_axis_sizes(mesh) if mesh is not None else {}

    # -------------------------------------------------------------- #
    def _present(self, axes: tuple[str, ...]) -> tuple[str, ...]:
        return tuple(a for a in axes if a in self._axis_size)

    def _axes_size(self, axes: tuple[str, ...]) -> int:
        return math.prod(self._axis_size[a] for a in axes)

    def logical(self, kind: str) -> tuple[str, ...]:
        pol = self.policy
        table = {
            "batch": pol.batch,
            "fsdp": pol.fsdp,
            "tp": pol.tp,
            "vocab": pol.tp if pol.shard_vocab else (),
            "experts": pol.tp if pol.expert_parallel else (),
            "cache_seq": pol.tp if pol.kv_layout == "sequence" else (),
            "cache_heads": pol.tp if pol.kv_layout == "heads" else (),
            "seq": pol.tp if pol.seq_parallel_acts else (),
            # unconditional seq-over-tp (uneven-head attention fallback)
            "force_seq": pol.tp,
            "none": (),
        }
        return self._present(table[kind])

    def tp_size(self) -> int:
        """Devices the tensor-parallel axes span (1 without a mesh)."""
        return self._axes_size(self.logical("tp"))

    def stationary(self, rows: int) -> str | None:
        """The kind of a product's contraction over the model width when
        its activation has `rows` batch rows: "fsdp" where the batch axes
        do not divide them (long_500k's global batch of 1), else None.
        GSPMD then leaves each weight's FSDP shard in place and splits
        the contraction over "data" against it, the partial sums reduced
        after, where it would otherwise gather the weight and run the
        same token's product on every "data" device."""
        axes = self.logical("batch")
        if self.mesh is None or rows % self._axes_size(axes) == 0:
            return None
        return "fsdp"

    def spec(self, dims: tuple[int, ...], kinds: tuple[str | None, ...],
             name: str = "?") -> PartitionSpec:
        """Build a PartitionSpec for a tensor, dropping non-dividing rules."""
        if self.mesh is None:
            return P()
        assert len(dims) == len(kinds), (name, dims, kinds)
        entries: list[Any] = []
        for dim, kind in zip(dims, kinds):
            if kind is None:
                entries.append(None)
                continue
            axes = self.logical(kind)
            if not axes:
                entries.append(None)
                continue
            size = self._axes_size(axes)
            if dim % size != 0:
                if kind in ("tp", "cache_heads") and self.policy.pad_uneven_heads:
                    entries.append(axes if len(axes) > 1 else axes[0])
                    continue
                self.dropped.append(f"{name}[{dim}]%{size}!=0 ({kind})")
                entries.append(None)
                continue
            entries.append(axes if len(axes) > 1 else axes[0])
        while entries and entries[-1] is None:
            entries.pop()
        return P(*entries)

    def named(self, dims, kinds, name="?"):
        """(mesh, placements) of the spec, or None without a mesh."""
        if self.mesh is None:
            return None
        return self.mesh, placements(self.spec(dims, kinds, name), self.mesh)

    def batch_spec(self, shape) -> PartitionSpec:
        """Batch-sharded on dim0, replicated elsewhere (tokens, labels).
        Falls back to replicated when the batch doesn't divide the axis
        (e.g. long_500k's global_batch=1)."""
        if self.mesh is None:
            return P()
        kinds = ("batch",) + (None,) * (len(tuple(shape)) - 1)
        return self.spec(tuple(shape), kinds, "batch")

    # -------------------------------------------------------------- #
    def _placements(self, shape, kinds, name: str) -> tuple:
        """Placements of the spec of `kinds`, its dropped rules taken back
        out of `dropped` and returned beside them."""
        n = len(self.dropped)
        plc = placements(self.spec(tuple(shape), tuple(kinds), name),
                         self.mesh)
        drops = self.dropped[n:]
        del self.dropped[n:]
        return plc, drops

    def _to(self, x, want: tuple):
        return x if tuple(x.placements) == want else \
            x.redistribute(self.mesh, want)

    def act(self, x, *kinds: str | None):
        """Constrain an activation's sharding: a no-op without a mesh or on
        a plain tensor, else `x` redistributed to the spec's placements.
        A rule that does not divide is kept once in `act_dropped`, not in
        `dropped` (the record of the parameter, input and cache specs)."""
        if self.mesh is None or not is_dtensor(x):
            return x
        want, drops = self._placements(x.shape, kinds, "act")
        self.act_dropped.update(dict.fromkeys(drops))
        return self._to(x, want)

    def lay(self, x, *kinds: str | None):
        """`x` laid out by `kinds` as an operand of the product it feeds:
        the layout GSPMD gives that operand from the constraints around
        the product, where DTensor would pick one from the operands'
        placements alone (it computed a product over the whole batch with
        the contraction split over "data", following an FSDP weight). A
        no-op without a mesh or on a plain tensor; a rule that does not
        divide leaves its dim replicated and is not recorded."""
        if self.mesh is None or not is_dtensor(x):
            return x
        return self._to(x, self._placements(x.shape, kinds, "lay")[0])

    def place(self, t: torch.Tensor, spec: PartitionSpec):
        """`t` (the whole tensor, on every rank) as a DTensor of `spec`."""
        from torch.distributed.tensor import distribute_tensor
        return distribute_tensor(t, self.mesh, placements(spec, self.mesh),
                                 src_data_rank=None)

    def implicit(self):
        """A context where plain tensors meet DTensors as replicated ones
        (constants a step makes: positions, masks, zeros); a null context
        without a mesh. Unlike torch's `implicit_replication` it nests: on
        exit it restores the setting it found."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return _implicit_replication()

    def local(self, fn: Callable, *args, n_out: int = 1):
        """`fn(*args)` on each device's batch rows: `local_with` with every
        DTensor argument and each of the `n_out` outputs batch-sharded on
        dim 0 (replicated where the rows do not divide the batch axes).
        For row-local work only: the MoE scatter and gather of a row's
        tokens."""
        if self.mesh is None or not any(is_dtensor(a) for a in args):
            return fn(*args)
        rows = next(a.shape[0] for a in args if is_dtensor(a))
        kinds = [("batch",) + (None,) * (a.dim() - 1) if is_dtensor(a)
                 else None for a in args]
        return self.local_with(fn, args, kinds,
                               [((rows,), ("batch",))] * n_out)

    def local_with(self, fn: Callable, args, in_kinds, outs):
        """`fn(*args)` on each device's shards (`local_map`), for work that
        is local along every sharded dim (a recurrent scan, row by row
        and channel by channel): tensor argument i is laid out by the
        logical kinds `in_kinds[i]` (None: not a tensor), and output j,
        of global shape `outs[j][0]`, comes back laid out by kinds
        `outs[j][1]` (with one entry, the output itself, not a tuple). A
        kind that does not divide its dim is replicated (and not recorded
        in `dropped`). An argument replicated on a mesh dim that another
        argument is sharded on feeds different work on each device
        there, so its gradient is a partial sum on that dim. Without a
        mesh, or without a DTensor argument, it is `fn(*args)`."""
        if self.mesh is None or not any(is_dtensor(a) for a in args):
            return fn(*args)
        from torch.distributed.tensor import DTensor, Partial, Replicate
        from torch.distributed.tensor.experimental import local_map

        def plc(shape, kinds):
            return list(self._placements(shape, kinds, "local")[0])

        full = [Replicate()] * self.mesh.ndim
        args = [DTensor.from_local(a, self.mesh, full, run_check=False)
                if torch.is_tensor(a) and not is_dtensor(a) else a
                for a in args]
        in_pl = tuple(None if k is None else plc(a.shape, k)
                      for a, k in zip(args, in_kinds))
        split = [self.mesh.size(i) > 1 and any(
            pl is not None and pl[i].is_shard() for pl in in_pl)
            for i in range(self.mesh.ndim)]
        grad_pl = tuple(None if pl is None else
                        [Partial() if split[i] and not p.is_shard() else p
                         for i, p in enumerate(pl)] for pl in in_pl)
        out_pl = tuple(plc(shape, kinds) for shape, kinds in outs)
        # local_map reads a tuple as one entry per output
        out = local_map(fn, out_placements=out_pl if len(out_pl) > 1
                        else out_pl[0], in_placements=in_pl,
                        in_grad_placements=grad_pl,
                        redistribute_inputs=True,
                        device_mesh=self.mesh)(*args)
        return tuple(map(_dense, out)) if len(out_pl) > 1 else _dense(out)


NO_SHARDING = Shardings(None)


def _dense(x):
    """A DTensor with the contiguous global strides of its shape (copied
    where they differ). `local_map` gives its outputs the strides
    `DTensor.from_local` computes, which are not contiguous across a
    size-1 dim: a (B, 1, D) decode activation then cannot fold into one
    `mm` against a weight, and `matmul` runs a `bmm` over the weight
    expanded to the whole batch instead."""
    if not is_dtensor(x) or x.stride() == _contiguous_strides(x.shape):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _contiguous_strides(shape) -> tuple:
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= n
    return tuple(reversed(out))


@contextlib.contextmanager
def _implicit_replication():
    from torch.distributed.tensor import DTensor
    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev


def full(x):
    """The whole tensor of a DTensor (gathered), or `x` itself."""
    return x.full_tensor() if is_dtensor(x) else x


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
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PartitionSpec):
        return type(tree)(tree_map(fn, t, is_leaf) for t in tree)
    return fn(tree)


def stack_defs(defs, n: int):
    """Add a leading (blocks) dim of size n to every ParamDef."""
    return tree_map(
        lambda d: ParamDef((n,) + d.shape, (None,) + d.kinds, d.name,
                           d.init, d.dtype), defs)


def tree_specs(shd: Shardings, defs) -> Any:
    """Map a tree of ParamDef -> tree of PartitionSpec."""
    return tree_map(lambda d: shd.spec(d.shape, d.kinds, d.name), defs)


def tree_shape_structs(defs, default_dtype) -> Any:
    """Map a tree of ParamDef -> tree of `meta` tensors of its shapes and
    dtypes (the dry run's stand-ins; no storage)."""
    from .config import torch_dtype
    return tree_map(lambda d: torch.empty(
        d.shape, dtype=torch_dtype(d.dtype or default_dtype), device="meta"),
        defs)
