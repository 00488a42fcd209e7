"""Hybrid dispatch runtime for chain pipelines: execute a plan in PyTorch.

The port of `repro.dispatch.runtime`. This module executes CHAIN-shaped
workloads (`Pipeline`: the mixed PrIM chain, the decode chain) stage by
stage. Operator-DAG workloads, the serving decode and prefill DAGs,
execute through the plan executor instead (`dispatch.executor.
PlanExecutor`), which walks the scheduler's launch-group timeline;
`bank_face` here is the leading-axis (batch) case of the `StageDef`
shard-axis faces that executor builds.

A `Pipeline` is a chain of `Stage`s, each with two executable faces:

  * `fn(x, *params)`    — host semantics, run eagerly when the plan
                          places the stage on xeon/titan_v;
  * `pim(grid, x, ...)` — the bank-parallel face, run as BankGrid local
                          and exchange phases when the plan places it on
                          a UPMEM system. Defaults to `grid.bank_map(fn)`
                          (the pure-streaming case); stages with
                          communication provide their own, built from
                          `grid.local` + `grid.exchange_*` as the
                          `repro_torch.prim` workloads are.

Both faces run on the grid's device (the card, or the CPU where the
caller asks for it): a bank is a split of an array's leading axis
(`core.bank_parallel`). Phase discipline is enforced as the PrIM suite
enforces it: a stage's declared bank-local body must trace with no
exchange and no collective (`core.bank_parallel.assert_local`);
inter-bank traffic must go through an exchange phase (Takeaway 3) and is
what `Stage.exchange`/`exchange_bytes` charge in the cost model.

`execute(pipeline, plan, grid)` runs every stage on its assigned device
and, with `validate`, checks the hybrid result against the single-device
reference (`reference(pipeline)`): exactly for integer results, with
`allclose` for float ones.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch.utils._pytree import tree_map

from ..core import census
from ..core.bank_parallel import BANKS, BankGrid, assert_local
from .graph import OpGraph, chain_graph, node_from_program


def bank_face(grid: BankGrid, fn: Callable, batched: tuple[bool, ...],
              n_out: int = 1) -> Callable:
    """Build a stage's bank-parallel face from its host face: args flagged
    True shard their leading (batch) dim over banks, others replicate to
    every bank (weights, rope tables, scalars); every output is
    batch-sharded. The continuous-batching-across-banks layout of
    DESIGN.md §4: each bank owns its slots' activations and KV rows, so
    the body stays a pure local phase (Takeaway 3)."""
    in_specs = tuple(BANKS if b else None for b in batched)
    out_specs = (BANKS,) * n_out if n_out > 1 else BANKS
    return grid.local(fn, in_specs=in_specs, out_specs=out_specs)


@dataclasses.dataclass
class Stage:
    """One dispatchable operator with host and bank-parallel faces."""
    name: str
    fn: Callable                       # fn(x, *params) -> y   (host face)
    params: tuple = ()
    pim: Callable | None = None        # pim(grid, x, *params) -> y
    local_fn: Callable | None = None   # bank-local body, for assert_local
    exchange: str | None = None        # exchange phase kind, if any (KT3)
    exchange_bytes: float | None = None  # None + exchange -> out_bytes
    hbm_bytes: float | None = None     # override the census's traffic (a
                                       # transpose is a free view here)
    kind: str = "stage"

    def run_host(self, x):
        """Execute the host face."""
        return self.fn(x, *self.params)

    def run_pim(self, grid: BankGrid, x):
        """Execute the bank-parallel face on `grid` (default: bank_map of
        the host face — the pure-streaming case)."""
        if self.pim is not None:
            return self.pim(grid, x, *self.params)
        return grid.bank_map(self.fn)(x, *self.params)


def _struct(t):
    """A storage-free twin of a tensor (shape, dtype) for costing."""
    if isinstance(t, torch.Tensor):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    return t


def _fn_key(fn) -> Any:
    """Cache identity for a stage fn: per-layer lambdas/partials built at
    the same source site share one trace."""
    if isinstance(fn, functools.partial):
        return ("partial", _fn_key(fn.func))
    return getattr(fn, "__code__", fn)


@dataclasses.dataclass
class Pipeline:
    """A chain of stages plus its example input — the executable twin of a
    chain OpGraph."""
    name: str
    stages: list[Stage]
    x: Any                             # input tensor (flows through stage 0)

    def stage(self, name: str) -> Stage:
        """The stage with the given name (StopIteration if absent)."""
        return next(s for s in self.stages if s.name == name)

    def graph(self) -> OpGraph:
        """Trace every stage alone on fake tensors and cost it as an
        OpNode. Params are explicit arguments (never closed-over
        constants), so weights show up as device-resident streams, while
        only the flowing activation prices the stage boundary."""
        x = tree_map(_struct, self.x)
        nodes, cache = [], {}
        for s in self.stages:
            args = (x, *tree_map(_struct, s.params))
            key = (_fn_key(s.fn), tuple(
                (tuple(t.shape), t.dtype) for t in
                torch.utils._pytree.tree_leaves(args)
                if isinstance(t, torch.Tensor)))
            if key not in cache:
                prog = census.trace_program(s.fn, *args)
                cache[key] = (node_from_program(s.name, prog, kind=s.kind),
                              [_out_struct(v) for v in prog.outputs])
            proto, outs = cache[key]
            # the cached prototype stays pristine: overrides touch a copy
            node = dataclasses.replace(proto, name=s.name, kind=s.kind,
                                       ops=dict(proto.ops),
                                       meta=dict(proto.meta))
            node.exchange_bytes = (s.exchange_bytes if s.exchange_bytes
                                   is not None else (node.out_bytes
                                                     if s.exchange else 0.0))
            if s.hbm_bytes is not None:
                node.hbm_bytes = s.hbm_bytes
            nodes.append(node)
            x = outs[0] if len(outs) == 1 else tuple(outs)
        return chain_graph(self.name, nodes, input_bytes=_nbytes(self.x))


def _out_struct(v: census.Value) -> torch.Tensor:
    return torch.empty(v.shape, dtype=v.dtype, device="meta")


def _nbytes(tree) -> float:
    return float(sum(t.numel() * t.element_size() for t in
                     torch.utils._pytree.tree_leaves(tree)
                     if isinstance(t, torch.Tensor)))


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def reference(pipeline: Pipeline):
    """Single-device oracle: the whole chain's host faces in order."""
    x = pipeline.x
    for s in pipeline.stages:
        x = s.fn(x, *s.params)
    return x


@dataclasses.dataclass
class ExecutionReport:
    """Outcome of a hybrid execution: the result, the single-device
    reference, and the verdict (`max_abs_err` in the output's own
    units)."""
    result: Any
    reference: Any
    matches: bool
    max_abs_err: float
    stage_devices: dict[str, str]


def execute(pipeline: Pipeline, plan, grid: BankGrid, *,
            validate: bool = True, rtol: float = 1e-4,
            atol: float = 1e-4) -> ExecutionReport:
    """Run the pipeline under a placement plan: PIM stages as BankGrid
    phases, host stages eagerly; optionally validate against the
    reference (bit for bit for integer results, allclose for float)."""
    x = pipeline.x
    devices = {}
    with torch.no_grad():
        for s in pipeline.stages:
            dev = plan.assignment[s.name]
            devices[s.name] = dev
            x = s.run_pim(grid, x) if dev.startswith("upmem") \
                else s.run_host(x)
        ref = reference(pipeline) if validate else None
    matches, err = True, 0.0
    if validate:
        if x.dtype.is_floating_point or ref.dtype.is_floating_point:
            a, b = x.double(), ref.double()
            err = float((a - b).abs().max())
            matches = bool(torch.allclose(a, b, rtol=rtol, atol=atol))
        else:
            err = float((x.long() - ref.long()).abs().max())
            matches = bool(torch.equal(x, ref))
        if not matches:
            raise AssertionError(
                f"hybrid execution of {pipeline.name} diverged from the "
                f"single-device reference (max |err| = {err:.3g})")
    return ExecutionReport(result=x, reference=ref, matches=matches,
                           max_abs_err=err, stage_devices=devices)


def check_phase_discipline(pipeline: Pipeline, grid: BankGrid) -> int:
    """assert_local every declared bank-local body on per-bank shards of
    the example inputs (Takeaway 3's discipline, the mechanism the PrIM
    tests use). Returns #stages checked."""
    def shard(t):
        if isinstance(t, torch.Tensor) and t.dim() \
                and t.shape[0] % grid.n_banks == 0:
            return t[: t.shape[0] // grid.n_banks]
        return t

    x = pipeline.x
    checked = 0
    with torch.no_grad():
        for s in pipeline.stages:
            if s.local_fn is not None:
                assert_local(s.local_fn, tree_map(shard, x),
                             *tree_map(shard, s.params))
                checked += 1
            x = s.fn(x, *s.params)
    return checked
